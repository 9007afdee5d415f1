"""Optimizer base (counterpart of `paddle_tpu/optimizer/optimizer.py`).

Every optimizer is its per-parameter rule `_rule(p, g, slots, lr) ->
(new_p, new_slots)` over raw torch tensors, a pure function run under
no_grad. The imperative `step()` and the functional `apply_gradients()`
share it: `step()` writes each result into the parameter's own torch
leaf, `apply_gradients()` returns new trees. With `multi_precision`,
bf16 and fp16 parameters keep float32 master weights in their slots.
"""
from __future__ import annotations

import contextlib
from collections import OrderedDict

import torch

from .._core.tensor import Parameter, Tensor, as_torch
from ..regularizer import L1Decay, L2Decay


# the groups over which the parameter being updated is split (its
# block's sums are partial): set around each update by the parallel
# Trainer and by step() for a placed parameter
_split_groups = ()


@contextlib.contextmanager
def split_over(groups):
    """Run the updates inside with tensor-wide sums (`whole_sum`) taken
    over `groups` as well: the update's parameter is this rank's block
    of a tensor split over them."""
    global _split_groups
    saved, _split_groups = _split_groups, tuple(groups)
    try:
        yield
    finally:
        _split_groups = saved


def whole_sum(x):
    """torch.sum(x) over the whole tensor `x` is a block of (Lamb's and
    LarsMomentum's norms): summed over the split groups."""
    s = torch.sum(x)
    if _split_groups:
        from ..distributed import collective as C
        for g in _split_groups:
            s = C.all_reduce(s.clone(), group=g)
    return s


def _placed_groups(p):
    """The groups a placed Parameter's block splits it over."""
    from ..parallel.mesh import placement
    where = placement(p)
    return () if where is None else tuple(where[0].group(ax)
                                          for ax in where[1])


def _tree_map(fn, *trees):
    """Map over matching dict / list / tuple trees of raw tensors."""
    t0 = trees[0]
    if isinstance(t0, dict) and not _is_slots(t0):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _is_slots(d):
    return "step" in d and not isinstance(d["step"], dict)


class Optimizer:
    _slot_names: tuple = ()

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False, **kwargs):
        self._parameter_list = list(parameters) if parameters is not None \
            else None
        if self._parameter_list and isinstance(self._parameter_list[0],
                                               dict):
            self._param_groups = self._parameter_list
            flat = []
            for g in self._param_groups:
                flat.extend(g["params"])
            self._parameter_list = flat
        else:
            self._param_groups = None
        self._learning_rate = learning_rate
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        if isinstance(weight_decay, float):
            self._regularization = L2Decay(weight_decay)
            self._weight_decay = weight_decay
        elif isinstance(weight_decay, (L1Decay, L2Decay)):
            self._regularization = weight_decay
            self._weight_decay = weight_decay.coeff
        else:
            self._regularization = None
            self._weight_decay = 0.0
        self._accumulators: dict = {}
        self._global_step = 0

    # ------------------------------------------------------------------ lr
    def get_lr(self):
        from .lr import LRScheduler
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value):
        from .lr import LRScheduler
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._learning_rate = float(value)

    def set_lr_scheduler(self, scheduler):
        self._learning_rate = scheduler

    # ------------------------------------------------------------- slots
    def _create_slots(self, p):
        """A float32 zeros slot per name, the step counter, and with
        multi_precision a float32 master of a bf16/fp16 parameter."""
        slots = {name: torch.zeros_like(p, dtype=torch.float32)
                 for name in self._slot_names}
        slots["step"] = torch.zeros((), dtype=torch.int32, device=p.device)
        if self._multi_precision and p.dtype in (torch.bfloat16,
                                                 torch.float16):
            slots["master"] = p.float()
        return slots

    def _rule(self, p, g, slots, lr):
        raise NotImplementedError

    def _apply_one(self, p_raw, g_raw, slots, lr, param_lr=1.0,
                   regularizer=None):
        """The shared pure update, with master weights and L1/L2 decay
        on the gradient."""
        reg = regularizer if regularizer is not None else \
            self._regularization
        work = slots.get("master", p_raw)
        g32 = g_raw.float() if work.dtype == torch.float32 else g_raw
        if reg is not None and not isinstance(
                self, _DecoupledWeightDecayMixin):
            g32 = reg(work.to(g32.dtype), g32)
        slots = dict(slots)
        slots["step"] = slots["step"] + 1
        new_work, slots = self._rule(work, g32, slots, lr * param_lr)
        if "master" in slots:
            slots["master"] = new_work
        return new_work.to(p_raw.dtype), slots

    # ------------------------------------------------------ imperative API
    @torch.no_grad()
    def step(self):
        params = [p for p in self._parameter_list
                  if isinstance(p, Parameter) and not p.stop_gradient]
        params_grads = [(p, p.grad) for p in params if p.grad is not None]
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        lr = self.get_lr()
        for p, g in params_grads:
            key = id(p)
            if key not in self._accumulators:
                self._accumulators[key] = self._create_slots(
                    p._value.detach())
            param_lr = p.optimize_attr.get("learning_rate", 1.0)
            with split_over(_placed_groups(p)):
                new_p, self._accumulators[key] = self._apply_one(
                    p._value.detach(), g._value, self._accumulators[key],
                    lr, param_lr, regularizer=getattr(p, "regularizer",
                                                      None) or
                    self._regularization)
            p._replace(new_p)
        self._global_step += 1

    minimize_step = step

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        return None, [(p, p.grad) for p in self._parameter_list or []]

    def clear_grad(self, set_to_zero=True):
        for p in self._parameter_list or []:
            p.grad = None

    clear_gradients = clear_grad

    # ------------------------------------------------------ functional API
    def init_state(self, params_tree):
        """A tree (dict / list / tuple) of raw tensors -> its slots tree."""
        return _tree_map(lambda p: self._create_slots(p), params_tree)

    @torch.no_grad()
    def apply_gradients(self, params_tree, grads_tree, state_tree, lr=None):
        """The pure update over trees: (new params, new state); nothing
        passed in is modified."""
        lr = self.get_lr() if lr is None else lr
        pairs = _tree_map(lambda p, g, s: self._apply_one(p, g, s, lr),
                          params_tree, grads_tree, state_tree)
        return _split(pairs, 0), _split(pairs, 1)

    # -------------------------------------------------------- state dict
    def state_dict(self):
        sd = OrderedDict()
        for i, p in enumerate(self._parameter_list or []):
            acc = self._accumulators.get(id(p))
            if acc is None:
                continue
            for k, v in acc.items():
                sd[f"{p.name or i}_{k}"] = Tensor(v)
        from .lr import LRScheduler
        if isinstance(self._learning_rate, LRScheduler):
            sd["LR_Scheduler"] = self._learning_rate.state_dict()
        sd["@global_step"] = self._global_step
        return sd

    def set_state_dict(self, state_dict):
        """Load slots by `{parameter name}_{slot}` keys (values: Tensors,
        torch tensors or arrays), onto each parameter's device."""
        from .lr import LRScheduler
        if "LR_Scheduler" in state_dict and isinstance(self._learning_rate,
                                                       LRScheduler):
            self._learning_rate.set_state_dict(state_dict["LR_Scheduler"])
        self._global_step = state_dict.get("@global_step", 0)
        for i, p in enumerate(self._parameter_list or []):
            prefix = f"{p.name or i}_"
            acc = {}
            for k, v in state_dict.items():
                if isinstance(k, str) and k.startswith(prefix):
                    acc[k[len(prefix):]] = as_torch(v).to(p._value.device)
            if acc:
                self._accumulators[id(p)] = acc

    load_state_dict = set_state_dict


def _split(pairs, i):
    if isinstance(pairs, dict):
        return {k: _split(v, i) for k, v in pairs.items()}
    if isinstance(pairs, list):
        return [_split(v, i) for v in pairs]
    if isinstance(pairs, tuple) and len(pairs) == 2 and \
            isinstance(pairs[1], dict) and _is_slots(pairs[1]):
        return pairs[i]
    return type(pairs)(_split(v, i) for v in pairs)


class _DecoupledWeightDecayMixin:
    """Marker: the rule applies weight decay itself (AdamW, Lamb, Lion)."""
