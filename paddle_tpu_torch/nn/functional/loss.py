"""Loss functionals (counterpart of `paddle_tpu/nn/functional/loss.py`),
each a torch function on Tensors. `cross_entropy` keeps the reference's
`ignore_index`, `reduction`, `soft_label`, weight and label-smoothing
behaviour and takes its log-softmax in float32. `ctc_loss`, `rnnt_loss`,
`adaptive_log_softmax_with_loss` and `hsigmoid_loss` wait for ROADMAP
item 13b."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

from ..._core.tensor import apply

__all__ = [
    "cross_entropy", "softmax_with_cross_entropy", "square_error_cost",
    "mse_loss", "l1_loss", "smooth_l1_loss", "nll_loss",
    "binary_cross_entropy", "binary_cross_entropy_with_logits", "kl_div",
    "margin_ranking_loss", "hinge_embedding_loss", "cosine_embedding_loss",
    "triplet_margin_loss", "triplet_margin_with_distance_loss", "huber_loss",
    "poisson_nll_loss", "gaussian_nll_loss", "sigmoid_focal_loss",
    "dice_loss", "log_loss", "npair_loss", "multi_label_soft_margin_loss",
    "soft_margin_loss", "multi_margin_loss", "margin_cross_entropy",
]


def _reduce(v, reduction):
    if reduction == "mean":
        return torch.mean(v)
    if reduction == "sum":
        return torch.sum(v)
    return v


def _zero(v):
    return torch.zeros((), dtype=v.dtype, device=v.device)


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    def fn(logits, lab, w=None):
        ax = axis % logits.dim()
        nclass = logits.shape[ax]
        logp = torch.log_softmax(logits.float(), ax) if use_softmax else \
            torch.log(torch.clamp_min(logits.float(), 1e-30))
        if soft_label or (lab.dim() == logits.dim() and
                          lab.shape == logits.shape):
            soft = lab.float()
            if label_smoothing > 0.0:
                soft = (1 - label_smoothing) * soft + label_smoothing / nclass
            loss = -torch.sum(soft * logp, ax)
            if w is not None:
                shape = [1] * logits.dim()
                shape[ax] = -1
                loss = loss * torch.sum(soft * w.reshape(shape), ax)
            return _reduce(loss, reduction)
        lab_i = lab.long()
        if lab_i.dim() == logits.dim():  # a trailing 1 dim
            lab_i = lab_i.squeeze(ax)
        valid = lab_i != ignore_index
        safe = torch.where(valid, lab_i, torch.zeros_like(lab_i))
        picked = torch.gather(logp, ax, safe.unsqueeze(ax)).squeeze(ax)
        if label_smoothing > 0.0:
            loss = -((1 - label_smoothing) * picked +
                     label_smoothing * torch.mean(logp, ax))
        else:
            loss = -picked
        loss = torch.where(valid, loss, _zero(loss))
        if w is not None:
            wt = torch.where(valid, w[safe], _zero(w))
            loss = loss * wt
            if reduction == "mean":
                return torch.sum(loss) / torch.clamp_min(torch.sum(wt), 1e-12)
        if reduction == "mean":
            cnt = torch.clamp_min(torch.sum(valid.float()), 1.0)
            return torch.sum(loss) / cnt
        return _reduce(loss, reduction)
    args = [input, label] + ([weight] if weight is not None else [])
    return apply(fn, *args)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    from .activation import softmax as _softmax
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis)
    loss = apply(lambda l: l.unsqueeze(axis), loss)
    if return_softmax:
        return loss, _softmax(logits, axis=axis)
    return loss


def square_error_cost(input, label):
    return apply(lambda a, b: torch.square(a - b), input, label)


def mse_loss(input, label, reduction="mean", name=None):
    return apply(lambda a, b: _reduce(torch.square(a - b), reduction),
                 input, label)


def l1_loss(input, label, reduction="mean", name=None):
    return apply(lambda a, b: _reduce(torch.abs(a - b), reduction),
                 input, label)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    def fn(a, b):
        d = torch.abs(a - b)
        loss = torch.where(d < delta, 0.5 * d * d / delta, d - 0.5 * delta)
        return _reduce(loss * delta, reduction)   # paddle scales by delta
    return apply(fn, input, label)


def huber_loss(input, label, delta=1.0, reduction="mean", name=None):
    def fn(a, b):
        d = torch.abs(a - b)
        loss = torch.where(d <= delta, 0.5 * d * d,
                           delta * (d - 0.5 * delta))
        return _reduce(loss, reduction)
    return apply(fn, input, label)


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    def fn(logp, lab, w=None):
        ax = 1 if logp.dim() > 1 else 0
        lab_i = lab.long()
        valid = lab_i != ignore_index
        safe = torch.where(valid, lab_i, torch.zeros_like(lab_i))
        loss = -torch.gather(logp, ax, safe.unsqueeze(ax)).squeeze(ax)
        wt = w[safe] if w is not None else torch.ones_like(loss)
        wt = torch.where(valid, wt, _zero(wt))
        loss = loss * wt
        if reduction == "mean":
            return torch.sum(loss) / torch.clamp_min(torch.sum(wt), 1e-12)
        return _reduce(loss, reduction)
    args = [input, label] + ([weight] if weight is not None else [])
    return apply(fn, *args)


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    def fn(p, t, w=None):
        p = torch.clamp(p, 1e-12, 1.0 - 1e-12)
        loss = -(t * torch.log(p) + (1 - t) * torch.log(1 - p))
        if w is not None:
            loss = loss * w
        return _reduce(loss, reduction)
    args = [input, label] + ([weight] if weight is not None else [])
    return apply(fn, *args)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    def fn(z, t, *rest):
        w = rest[0] if weight is not None else None
        pw = rest[-1] if pos_weight is not None else None
        if pw is not None:
            loss = -(pw * t * TF.logsigmoid(z) +
                     (1 - t) * TF.logsigmoid(-z))
        else:
            loss = torch.clamp_min(z, 0) - z * t + \
                torch.log1p(torch.exp(-torch.abs(z)))
        if w is not None:
            loss = loss * w
        return _reduce(loss, reduction)
    args = [logit, label] + [a for a in (weight, pos_weight)
                             if a is not None]
    return apply(fn, *args)


def kl_div(input, label, reduction="mean", log_target=False, name=None):
    def fn(logp, t):
        if log_target:
            loss = torch.exp(t) * (t - logp)
        else:
            loss = torch.where(t > 0, t * (torch.log(torch.clamp_min(
                t, 1e-30)) - logp), _zero(logp))
        if reduction == "batchmean":
            return torch.sum(loss) / logp.shape[0]
        return _reduce(loss, reduction)
    return apply(fn, input, label)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    return apply(lambda a, b, t: _reduce(torch.clamp_min(
        -t * (a - b) + margin, 0.0), reduction), input, other, label)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    return apply(lambda a, t: _reduce(torch.where(
        t == 1, a, torch.clamp_min(margin - a, 0.0)), reduction),
        input, label)


def cosine_embedding_loss(input1, input2, label, margin=0, reduction="mean",
                          name=None):
    def fn(a, b, t):
        cos = torch.sum(a * b, -1) / torch.clamp_min(
            torch.linalg.vector_norm(a, dim=-1) *
            torch.linalg.vector_norm(b, dim=-1), 1e-12)
        loss = torch.where(t == 1, 1 - cos, torch.clamp_min(cos - margin,
                                                            0.0))
        return _reduce(loss, reduction)
    return apply(fn, input1, input2, label)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    def fn(a, pos, neg):
        def dist(u, v):
            return torch.pow(torch.sum(torch.pow(torch.abs(u - v) + epsilon,
                                                 p), -1), 1 / p)
        d_ap, d_an = dist(a, pos), dist(a, neg)
        if swap:
            d_an = torch.minimum(d_an, dist(pos, neg))
        return _reduce(torch.clamp_min(d_ap - d_an + margin, 0.0), reduction)
    return apply(fn, input, positive, negative)


def triplet_margin_with_distance_loss(input, positive, negative,
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean",
                                      name=None):
    if distance_function is None:
        return triplet_margin_loss(input, positive, negative, margin=margin,
                                   swap=swap, reduction=reduction)
    d_ap = distance_function(input, positive)
    d_an = distance_function(input, negative)
    if swap:
        d_an = apply(torch.minimum, d_an,
                     distance_function(positive, negative))
    return apply(lambda a, b: _reduce(torch.clamp_min(a - b + margin, 0.0),
                                      reduction), d_ap, d_an)


def multi_label_soft_margin_loss(input, label, weight=None, reduction="mean",
                                 name=None):
    def fn(z, t, w=None):
        loss = -(t * TF.logsigmoid(z) + (1 - t) * TF.logsigmoid(-z))
        loss = torch.mean(loss, -1)
        if w is not None:
            loss = loss * w
        return _reduce(loss, reduction)
    args = [input, label] + ([weight] if weight is not None else [])
    return apply(fn, *args)


def soft_margin_loss(input, label, reduction="mean", name=None):
    return apply(lambda z, t: _reduce(torch.log1p(torch.exp(-t * z)),
                                      reduction), input, label)


def multi_margin_loss(input, label, p=1, margin=1.0, weight=None,
                      reduction="mean", name=None):
    def fn(z, t, w=None):
        c = z.shape[1]
        t = t.long()
        correct = torch.gather(z, 1, t[:, None])
        diff = torch.pow(torch.clamp_min(margin - correct + z, 0.0), p)
        if w is not None:
            diff = diff * w[t][:, None]
        mask = TF.one_hot(t, c).to(z.dtype)
        return _reduce(torch.sum(diff * (1 - mask), 1) / c, reduction)
    args = [input, label] + ([weight] if weight is not None else [])
    return apply(fn, *args)


def poisson_nll_loss(input, label, log_input=True, full=False,
                     epsilon=1e-8, reduction="mean", name=None):
    def fn(z, t):
        loss = torch.exp(z) - t * z if log_input else \
            z - t * torch.log(z + epsilon)
        if full:
            stirling = t * torch.log(t + 1e-12) - t + \
                0.5 * torch.log(2 * math.pi * (t + 1e-12))
            loss = loss + torch.where(t > 1, stirling, _zero(stirling))
        return _reduce(loss, reduction)
    return apply(fn, input, label)


def gaussian_nll_loss(input, label, variance, full=False, epsilon=1e-6,
                      reduction="mean", name=None):
    def fn(mu, t, var):
        var = torch.clamp_min(var, epsilon)
        loss = 0.5 * (torch.log(var) + torch.square(mu - t) / var)
        if full:
            loss = loss + 0.5 * math.log(2 * math.pi)
        return _reduce(loss, reduction)
    return apply(fn, input, label, variance)


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    def fn(z, t, nrm=None):
        p = torch.sigmoid(z)
        ce = torch.clamp_min(z, 0) - z * t + \
            torch.log1p(torch.exp(-torch.abs(z)))
        p_t = p * t + (1 - p) * (1 - t)
        a_t = alpha * t + (1 - alpha) * (1 - t)
        loss = a_t * torch.pow(1 - p_t, gamma) * ce
        if nrm is not None:
            loss = loss / nrm
        return _reduce(loss, reduction)
    args = [logit, label] + ([normalizer] if normalizer is not None else [])
    return apply(fn, *args)


def dice_loss(input, label, epsilon=1e-5, name=None):
    def fn(p, t):
        t_oh = TF.one_hot(t.squeeze(-1).long(), p.shape[-1]).to(p.dtype)
        red = tuple(range(1, p.dim()))
        inter = torch.sum(p * t_oh, red)
        union = torch.sum(p, red) + torch.sum(t_oh, red)
        return torch.mean(1 - (2 * inter + epsilon) / (union + epsilon))
    return apply(fn, input, label)


def log_loss(input, label, epsilon=1e-4, name=None):
    return apply(lambda p, t: -t * torch.log(p + epsilon) -
                 (1 - t) * torch.log(1 - p + epsilon), input, label)


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    def fn(a, p, lab):
        sim = a @ p.T
        eq = (lab[:, None] == lab[None, :]).float()
        eq = eq / torch.sum(eq, 1, keepdim=True)
        xent = torch.mean(torch.sum(-eq * torch.log_softmax(sim, 1), 1))
        reg = l2_reg * (torch.mean(torch.sum(a * a, 1)) +
                        torch.mean(torch.sum(p * p, 1))) * 0.25
        return xent + reg
    return apply(fn, anchor, positive, labels)


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, group=None,
                         return_softmax=False, reduction="mean"):
    def fn(z, t):
        ti = t.long().reshape(-1)
        theta = torch.arccos(torch.clamp(torch.gather(z, 1, ti[:, None]),
                                         -1, 1))
        target_logit = torch.cos(margin1 * theta + margin2) - margin3
        onehot = TF.one_hot(ti, z.shape[-1]).to(z.dtype)
        new_z = scale * (z * (1 - onehot) + target_logit * onehot)
        loss = -torch.gather(torch.log_softmax(new_z, 1), 1, ti[:, None])
        if reduction == "mean":
            loss = torch.mean(loss)
        elif reduction == "sum":
            loss = torch.sum(loss)
        if return_softmax:
            return loss, torch.softmax(new_z, 1)
        return loss
    return apply(fn, logits, label, multi=return_softmax)
