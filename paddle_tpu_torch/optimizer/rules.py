"""Concrete optimizers (counterpart of `paddle_tpu/optimizer/rules.py`).
Each is only its pure update rule, torch ops on raw tensors.

AdamW keeps the reference's `lr_ratio` and `apply_decay_param_fun`
arguments and, as the reference does, does not apply them: its rule
decays every parameter at the full rate (ROADMAP.md, Queue 3)."""
from __future__ import annotations

import torch

from .optimizer import Optimizer, _DecoupledWeightDecayMixin, whole_sum


class SGD(Optimizer):
    def _rule(self, p, g, slots, lr):
        return p - lr * g, slots


class Momentum(Optimizer):
    _slot_names = ("velocity",)

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name,
                         multi_precision)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _rule(self, p, g, slots, lr):
        v = self._momentum * slots["velocity"] + g
        slots["velocity"] = v
        if self._use_nesterov:
            return p - lr * (g + self._momentum * v), slots
        return p - lr * v, slots


class Adam(Optimizer):
    _slot_names = ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 parameters=None, weight_decay=None, grad_clip=None, lazy_mode=False,
                 multi_precision=False, use_multi_tensor=False, name=None,
                 amsgrad=False, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name,
                         multi_precision)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._amsgrad = amsgrad
        if amsgrad:
            self._slot_names = ("moment1", "moment2", "moment2_max")

    def _rule(self, p, g, slots, lr):
        t = slots["step"].float()
        m = self._beta1 * slots["moment1"] + (1 - self._beta1) * g
        v = self._beta2 * slots["moment2"] + (1 - self._beta2) * g * g
        slots["moment1"], slots["moment2"] = m, v
        mhat = m / (1 - self._beta1 ** t)
        vhat = v / (1 - self._beta2 ** t)
        if self._amsgrad:
            vmax = torch.maximum(slots["moment2_max"], vhat)
            slots["moment2_max"] = vmax
            vhat = vmax
        return p - lr * mhat / (torch.sqrt(vhat) + self._epsilon), slots


class AdamW(Adam, _DecoupledWeightDecayMixin):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 parameters=None, weight_decay=0.01, lr_ratio=None,
                 apply_decay_param_fun=None, grad_clip=None, lazy_mode=False,
                 multi_precision=False, name=None, amsgrad=False, **kw):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision, name=name,
                         amsgrad=amsgrad)
        self._coeff = weight_decay if isinstance(weight_decay, float) else \
            getattr(weight_decay, "coeff", 0.01)
        self._apply_decay_param_fun = apply_decay_param_fun
        self._lr_ratio = lr_ratio

    def _rule(self, p, g, slots, lr):
        p = p * (1.0 - lr * self._coeff)
        return super()._rule(p, g, slots, lr)


class Adamax(Optimizer):
    _slot_names = ("moment", "inf_norm")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 parameters=None, weight_decay=None, grad_clip=None, name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _rule(self, p, g, slots, lr):
        t = slots["step"].float()
        m = self._beta1 * slots["moment"] + (1 - self._beta1) * g
        u = torch.maximum(self._beta2 * slots["inf_norm"], torch.abs(g))
        slots["moment"], slots["inf_norm"] = m, u
        return p - (lr / (1 - self._beta1 ** t)) * m / (u + self._epsilon), slots


class Adagrad(Optimizer):
    _slot_names = ("moment",)

    def __init__(self, learning_rate=0.001, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 initial_accumulator_value=0.0, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _create_slots(self, p):
        slots = super()._create_slots(p)
        slots["moment"] = torch.full_like(p, self._init_acc,
                                          dtype=torch.float32)
        return slots

    def _rule(self, p, g, slots, lr):
        acc = slots["moment"] + g * g
        slots["moment"] = acc
        return p - lr * g / (torch.sqrt(acc) + self._epsilon), slots


class Adadelta(Optimizer):
    _slot_names = ("avg_squared_grad", "avg_squared_update")

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95, parameters=None,
                 weight_decay=None, grad_clip=None, name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name)
        self._epsilon, self._rho = epsilon, rho

    def _rule(self, p, g, slots, lr):
        sq = self._rho * slots["avg_squared_grad"] + (1 - self._rho) * g * g
        upd = torch.sqrt(slots["avg_squared_update"] + self._epsilon) / \
            torch.sqrt(sq + self._epsilon) * g
        slots["avg_squared_grad"] = sq
        slots["avg_squared_update"] = self._rho * slots["avg_squared_update"] + \
            (1 - self._rho) * upd * upd
        return p - lr * upd, slots


class RMSProp(Optimizer):
    _slot_names = ("mean_square", "mean_grad", "momentum_acc")

    def __init__(self, learning_rate=0.001, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None, grad_clip=None,
                 name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _rule(self, p, g, slots, lr):
        ms = self._rho * slots["mean_square"] + (1 - self._rho) * g * g
        slots["mean_square"] = ms
        if self._centered:
            mg = self._rho * slots["mean_grad"] + (1 - self._rho) * g
            slots["mean_grad"] = mg
            denom = torch.sqrt(ms - mg * mg + self._epsilon)
        else:
            denom = torch.sqrt(ms + self._epsilon)
        mom = self._momentum * slots["momentum_acc"] + lr * g / denom
        slots["momentum_acc"] = mom
        return p - mom, slots


class Lamb(Optimizer, _DecoupledWeightDecayMixin):
    _slot_names = ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01, beta1=0.9,
                 beta2=0.999, epsilon=1e-6, parameters=None, grad_clip=None,
                 exclude_from_weight_decay_fn=None, multi_precision=False,
                 name=None, **kw):
        super().__init__(learning_rate, parameters, None, grad_clip, name,
                         multi_precision)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._lamb_wd = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _rule(self, p, g, slots, lr):
        t = slots["step"].float()
        m = self._beta1 * slots["moment1"] + (1 - self._beta1) * g
        v = self._beta2 * slots["moment2"] + (1 - self._beta2) * g * g
        slots["moment1"], slots["moment2"] = m, v
        mhat = m / (1 - self._beta1 ** t)
        vhat = v / (1 - self._beta2 ** t)
        r = mhat / (torch.sqrt(vhat) + self._epsilon) + self._lamb_wd * p
        w_norm = torch.sqrt(whole_sum(p * p))
        r_norm = torch.sqrt(whole_sum(r * r))
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm))
        return p - lr * trust * r, slots


class LarsMomentum(Optimizer):
    """Layer-wise adaptive rate scaling + momentum (reference:
    python/paddle/incubate/optimizer/lars_momentum.py:25,
    paddle/phi/kernels/gpu/lars_momentum_kernel.cu):

        local_lr = lr * lars_coeff * ||p|| /
                   (||g|| + lars_weight_decay * ||p|| + eps)
        v        = mu * v + local_lr * (g + lars_weight_decay * p)
        p        = p - v

    (epsilon guards the local_lr division, per the reference's
    documented purpose "avoid Division by Zero when calculate local
    lr" — its docstring typesets eps inside the velocity term, but the
    division guard is the semantic.)

    The reference's per-layer exclude_from_weight_decay name list is
    not carried here (the functional rule sees arrays, not names);
    construct a second LarsMomentum(lars_weight_decay=0.0) for the
    excluded parameter group instead.
    """
    _slot_names = ("velocity",)

    def __init__(self, learning_rate=0.001, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, parameters=None, regularization=None,
                 grad_clip=None, name=None, epsilon=0.0, multi_precision=False,
                 rescale_grad=1.0, **kw):
        super().__init__(learning_rate, parameters, regularization, grad_clip,
                         name, multi_precision)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_wd = lars_weight_decay
        self._epsilon = epsilon
        self._rescale_grad = rescale_grad

    def _rule(self, p, g, slots, lr):
        g = g * self._rescale_grad
        p_norm = torch.sqrt(whole_sum(p.float() ** 2))
        g_norm = torch.sqrt(whole_sum(g.float() ** 2))
        denom = g_norm + self._lars_wd * p_norm + self._epsilon
        # gate on g_norm (not denom): the reference kernel falls back to
        # plain lr when EITHER norm is zero, so a zero-grad param decays
        # at lr*wd, not at the coeff/wd-scaled rate
        local_lr = torch.where((p_norm > 0) & (g_norm > 0),
                               lr * self._lars_coeff * p_norm /
                               torch.clamp_min(denom, 1e-30),
                               torch.full_like(p_norm, lr))
        v = self._momentum * slots["velocity"] \
            + local_lr * (g + self._lars_wd * p)
        slots["velocity"] = v
        return p - v, slots


class NAdam(Optimizer):
    _slot_names = ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 momentum_decay=0.004, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._psi = momentum_decay

    def _create_slots(self, p):
        slots = super()._create_slots(p)
        slots["mu_product"] = torch.ones((), dtype=torch.float32,
                                         device=p.device)
        return slots

    def _rule(self, p, g, slots, lr):
        t = slots["step"].float()
        mu_t = self._beta1 * (1 - 0.5 * 0.96 ** (t * self._psi))
        mu_t1 = self._beta1 * (1 - 0.5 * 0.96 ** ((t + 1) * self._psi))
        mu_prod = slots["mu_product"] * mu_t
        slots["mu_product"] = mu_prod
        m = self._beta1 * slots["moment1"] + (1 - self._beta1) * g
        v = self._beta2 * slots["moment2"] + (1 - self._beta2) * g * g
        slots["moment1"], slots["moment2"] = m, v
        mhat = mu_t1 * m / (1 - mu_prod * mu_t1) + (1 - mu_t) * g / (1 - mu_prod)
        vhat = v / (1 - self._beta2 ** t)
        return p - lr * mhat / (torch.sqrt(vhat) + self._epsilon), slots


class RAdam(Optimizer):
    _slot_names = ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 parameters=None, weight_decay=None, grad_clip=None, name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _rule(self, p, g, slots, lr):
        t = slots["step"].float()
        m = self._beta1 * slots["moment1"] + (1 - self._beta1) * g
        v = self._beta2 * slots["moment2"] + (1 - self._beta2) * g * g
        slots["moment1"], slots["moment2"] = m, v
        mhat = m / (1 - self._beta1 ** t)
        rho_inf = 2.0 / (1 - self._beta2) - 1
        rho_t = rho_inf - 2 * t * self._beta2 ** t / (1 - self._beta2 ** t)
        vhat = torch.sqrt(v / (1 - self._beta2 ** t))
        r = torch.sqrt(((rho_t - 4) * (rho_t - 2) * rho_inf) /
                       torch.clamp_min((rho_inf - 4) * (rho_inf - 2) * rho_t,
                                       1e-8))
        upd = torch.where(rho_t > 5.0, r * mhat / (vhat + self._epsilon),
                          mhat)
        return p - lr * upd, slots


class ASGD(Optimizer):
    _slot_names = ("d", "ys")

    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name,
                         multi_precision)
        self._batch_num = batch_num

    def _rule(self, p, g, slots, lr):
        # simplified averaged-SGD accumulation
        d = slots["d"] - slots["ys"] + g
        slots["d"] = d
        slots["ys"] = g
        return p - lr / self._batch_num * d, slots


class Rprop(Optimizer):
    _slot_names = ("prev_grad", "lr_slot")

    def __init__(self, learning_rate=0.001, learning_rate_range=(1e-5, 50.0),
                 parameters=None, etas=(0.5, 1.2), grad_clip=None, name=None, **kw):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._lr_min, self._lr_max = learning_rate_range
        self._eta_minus, self._eta_plus = etas

    def _create_slots(self, p):
        slots = super()._create_slots(p)
        slots["lr_slot"] = torch.full_like(p, self.get_lr(),
                                           dtype=torch.float32)
        return slots

    def _rule(self, p, g, slots, lr):
        sign = torch.sign(g * slots["prev_grad"])
        one = torch.ones_like(sign)
        factor = torch.where(sign > 0, self._eta_plus * one,
                             torch.where(sign < 0, self._eta_minus * one,
                                         one))
        lrs = torch.clamp(slots["lr_slot"] * factor, self._lr_min,
                          self._lr_max)
        g_eff = torch.where(sign < 0, torch.zeros_like(g), g)
        slots["prev_grad"] = g_eff
        slots["lr_slot"] = lrs
        return p - lrs * torch.sign(g_eff), slots


class Lion(Optimizer, _DecoupledWeightDecayMixin):
    """Lion (extra vs reference — common in TPU training stacks)."""

    _slot_names = ("moment",)

    def __init__(self, learning_rate=1e-4, beta1=0.9, beta2=0.99, parameters=None,
                 weight_decay=0.0, grad_clip=None, name=None, **kw):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._beta1, self._beta2 = beta1, beta2
        self._coeff = weight_decay

    def _rule(self, p, g, slots, lr):
        m = slots["moment"]
        update = torch.sign(self._beta1 * m + (1 - self._beta1) * g)
        slots["moment"] = self._beta2 * m + (1 - self._beta2) * g
        p = p * (1 - lr * self._coeff)
        return p - lr * update, slots


class LBFGS(Optimizer):
    """Minimal L-BFGS with closure (reference: python/paddle/optimizer/lbfgs.py).

    History-based two-loop recursion; eager-only (uses closure re-eval)."""

    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-7, tolerance_change=1e-9, history_size=100,
                 line_search_fn=None, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name)
        self._max_iter = max_iter
        self._history_size = history_size
        self._s, self._y = [], []
        self._prev_flat_grad = None
        self._prev_flat_param = None

    def _flat(self, vals):
        return torch.cat([v.reshape(-1).float() for v in vals])

    @torch.no_grad()
    def step(self, closure=None):
        if closure is None:
            raise ValueError("LBFGS.step requires a closure")
        with torch.enable_grad():
            loss = closure()
        params = [p for p in self._parameter_list if not p.stop_gradient]
        grads = [p.grad._value if p.grad is not None else
                 torch.zeros_like(p._value) for p in params]
        flat_g = self._flat(grads)
        flat_p = self._flat([p._value.detach() for p in params])
        if self._prev_flat_grad is not None:
            s = flat_p - self._prev_flat_param
            y = flat_g - self._prev_flat_grad
            if float(torch.dot(s, y)) > 1e-10:
                self._s.append(s)
                self._y.append(y)
                if len(self._s) > self._history_size:
                    self._s.pop(0)
                    self._y.pop(0)
        q = flat_g
        alphas = []
        for s, y in zip(reversed(self._s), reversed(self._y)):
            rho = 1.0 / torch.dot(y, s)
            a = rho * torch.dot(s, q)
            q = q - a * y
            alphas.append((a, rho))
        if self._s:
            gamma = torch.dot(self._s[-1], self._y[-1]) / \
                torch.dot(self._y[-1], self._y[-1])
            q = gamma * q
        for (a, rho), s, y in zip(reversed(alphas), self._s, self._y):
            b = rho * torch.dot(y, q)
            q = q + (a - b) * s
        direction = -q
        lr = self.get_lr()
        offset = 0
        for p in params:
            n = p._value.numel()
            upd = direction[offset:offset + n].reshape(p._value.shape)
            p._replace((p._value.detach().float() + lr * upd).to(p.dtype))
            offset += n
        self._prev_flat_grad = flat_g
        self._prev_flat_param = flat_p + lr * direction
        return loss
