"""nn.Layer (counterpart of `paddle_tpu/nn/layer/layers.py`).

Paddle's module system over the port's Tensor: parameters are
`Parameter`s, each one torch leaf for its life. `functional_state()` /
`functional_call()` turn a Layer tree into a pure (params, buffers,
inputs) -> outputs function over raw torch tensors, which the parallel
trainer differentiates.
"""
from __future__ import annotations

import contextlib
from collections import OrderedDict

import torch

from ..._core import dtypes as _dt
from ..._core.tensor import Parameter, Tensor, as_torch
from ..initializer import Constant, Initializer, XavierUniform


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, Initializer):
            return ParamAttr(initializer=attr)
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if attr is False:
            return False
        return ParamAttr()


_name_counter = {}


def _unique_name(prefix):
    i = _name_counter.get(prefix, 0)
    _name_counter[prefix] = i + 1
    return f"{prefix}_{i}"


class HookRemoveHelper:
    def __init__(self, hooks, hook_id):
        self._hooks = hooks
        self._hook_id = hook_id

    def remove(self):
        self._hooks.pop(self._hook_id, None)


class Layer:
    def __init__(self, name_scope=None, dtype="float32"):
        self.training = True
        self._dtype = _dt.convert_dtype(dtype) if dtype else \
            _dt.get_default_dtype()
        self._parameters = OrderedDict()
        self._buffers = OrderedDict()
        self._non_persistable_buffer_names_set = set()
        self._sub_layers = OrderedDict()
        self._forward_pre_hooks = OrderedDict()
        self._forward_post_hooks = OrderedDict()
        self._hook_id = 0
        self._name_scope = name_scope or self.__class__.__name__.lower()
        self._full_name = _unique_name(self._name_scope)
        self._casted_by_pure_fp16 = False

    # -- registration -------------------------------------------------------
    def __setattr__(self, name, value):
        params = self.__dict__.get("_parameters")
        layers = self.__dict__.get("_sub_layers")
        buffers = self.__dict__.get("_buffers")
        if isinstance(value, Parameter):
            if params is None:
                raise RuntimeError("call super().__init__() first")
            params[name] = value
            self.__dict__.pop(name, None)
        elif isinstance(value, Layer):
            if layers is None:
                raise RuntimeError("call super().__init__() first")
            layers[name] = value
            self.__dict__.pop(name, None)
        elif params is not None and name in params:
            if value is None:
                params[name] = None
            elif isinstance(value, Tensor):
                params[name] = Parameter(value._value, name=params[name].name)
            else:
                raise TypeError(
                    f"cannot assign {type(value)} to parameter {name}")
        elif buffers is not None and name in buffers:
            if value is None or isinstance(value, Tensor):
                buffers[name] = value
            else:
                object.__setattr__(self, name, value)
        elif layers is not None and name in layers:
            if value is None:
                layers.pop(name)
                object.__setattr__(self, name, None)
            else:
                object.__setattr__(self, name, value)
        else:
            object.__setattr__(self, name, value)

    def __getattr__(self, name):
        d = self.__dict__
        for store in ("_parameters", "_sub_layers", "_buffers"):
            if store in d and name in d[store]:
                return d[store][name]
        raise AttributeError(
            f"'{self.__class__.__name__}' object has no attribute '{name}'")

    def __delattr__(self, name):
        for d in (self._parameters, self._buffers, self._sub_layers):
            if name in d:
                del d[name]
                return
        object.__delattr__(self, name)

    def __dir__(self):
        return list(super().__dir__()) + list(self._parameters) + \
            list(self._sub_layers) + list(self._buffers)

    # -- parameter creation -------------------------------------------------
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        d = _dt.convert_dtype(dtype) if dtype is not None else self._dtype
        if default_initializer is None:
            init = attr.initializer if attr.initializer is not None else \
                (Constant(0.0) if is_bias else XavierUniform())
        else:
            init = attr.initializer if attr.initializer is not None else \
                default_initializer
        value = init._generate(tuple(int(s) for s in shape), d)
        p = Parameter(value, name=attr.name or _unique_name("param"),
                      trainable=attr.trainable)
        p.optimize_attr["learning_rate"] = attr.learning_rate
        p.regularizer = attr.regularizer
        p.need_clip = attr.need_clip
        return p

    def create_variable(self, name=None, persistable=None, dtype=None):
        from ..._core.state import torch_device
        d = _dt.convert_dtype(dtype) if dtype is not None else self._dtype
        t = Tensor(torch.zeros((), dtype=d, device=torch_device()), name=name)
        t.persistable = bool(persistable)
        return t

    create_tensor = create_variable

    def add_parameter(self, name, parameter):
        if parameter is not None and not isinstance(parameter, Parameter):
            raise TypeError("add_parameter expects a Parameter")
        self._parameters[name] = parameter
        return parameter

    def add_sublayer(self, name, sublayer):
        self._sub_layers[str(name)] = sublayer
        return sublayer

    def register_buffer(self, name, tensor, persistable=True):
        self._buffers[name] = tensor
        if not persistable:
            self._non_persistable_buffer_names_set.add(name)
        return tensor

    # -- traversal ----------------------------------------------------------
    def parameters(self, include_sublayers=True):
        return [p for _, p in self.named_parameters(
            include_sublayers=include_sublayers)]

    def named_parameters(self, prefix="", include_sublayers=True):
        seen = set()
        for name, layer in self.named_sublayers(prefix=prefix,
                                                include_self=True):
            if not include_sublayers and layer is not self:
                continue
            for pname, p in layer._parameters.items():
                if p is None or id(p) in seen:
                    continue
                seen.add(id(p))
                yield (f"{name}.{pname}" if name else pname), p

    def buffers(self, include_sublayers=True):
        return [b for _, b in self.named_buffers(
            include_sublayers=include_sublayers)]

    def named_buffers(self, prefix="", include_sublayers=True):
        seen = set()
        for name, layer in self.named_sublayers(prefix=prefix,
                                                include_self=True):
            if not include_sublayers and layer is not self:
                continue
            for bname, b in layer._buffers.items():
                if b is None or id(b) in seen:
                    continue
                seen.add(id(b))
                yield (f"{name}.{bname}" if name else bname), b

    def children(self):
        for _, l in self.named_children():
            yield l

    def named_children(self):
        seen = set()
        for name, layer in self._sub_layers.items():
            if layer is not None and id(layer) not in seen:
                seen.add(id(layer))
                yield name, layer

    def sublayers(self, include_self=False):
        return [l for _, l in self.named_sublayers(include_self=include_self)]

    def named_sublayers(self, prefix="", include_self=False,
                        layers_set=None):
        if layers_set is None:
            layers_set = set()
        if include_self and id(self) not in layers_set:
            layers_set.add(id(self))
            yield prefix, self
        for name, layer in self._sub_layers.items():
            if layer is None or id(layer) in layers_set:
                continue
            layers_set.add(id(layer))
            sub_prefix = f"{prefix}.{name}" if prefix else name
            yield sub_prefix, layer
            yield from layer.named_sublayers(prefix=sub_prefix,
                                             include_self=False,
                                             layers_set=layers_set)

    def apply(self, fn):
        for l in self.children():
            l.apply(fn)
        fn(self)
        return self

    def full_name(self):
        return self._full_name

    # -- mode ---------------------------------------------------------------
    def train(self):
        self.training = True
        for l in self.sublayers():
            l.training = True
        return self

    def eval(self):
        self.training = False
        for l in self.sublayers():
            l.training = False
        return self

    # -- hooks --------------------------------------------------------------
    def register_forward_pre_hook(self, hook):
        self._hook_id += 1
        self._forward_pre_hooks[self._hook_id] = hook
        return HookRemoveHelper(self._forward_pre_hooks, self._hook_id)

    def register_forward_post_hook(self, hook):
        self._hook_id += 1
        self._forward_post_hooks[self._hook_id] = hook
        return HookRemoveHelper(self._forward_post_hooks, self._hook_id)

    # -- call ---------------------------------------------------------------
    def forward(self, *inputs, **kwargs):
        raise NotImplementedError

    def __call__(self, *inputs, **kwargs):
        for hook in self._forward_pre_hooks.values():
            result = hook(self, inputs)
            if result is not None:
                inputs = result if isinstance(result, tuple) else (result,)
        out = self.forward(*inputs, **kwargs)
        for hook in self._forward_post_hooks.values():
            result = hook(self, inputs, out)
            if result is not None:
                out = result
        return out

    # -- state dict ---------------------------------------------------------
    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix="", use_hook=True):
        dest = destination if destination is not None else OrderedDict()
        for name, p in self.named_parameters(
                include_sublayers=include_sublayers):
            dest[structured_name_prefix + name] = p
        for name, b in self.named_buffers(
                include_sublayers=include_sublayers):
            skip = False
            for lname, layer in self.named_sublayers(include_self=True):
                bn = name.split(".")[-1]
                if name == (f"{lname}.{bn}" if lname else bn) and \
                        bn in layer._non_persistable_buffer_names_set:
                    skip = True
                    break
            if not skip:
                dest[structured_name_prefix + name] = b
        return dest

    def to_static_state_dict(self, destination=None, include_sublayers=True,
                             structured_name_prefix="", use_hook=True,
                             keep_vars=True):
        d = self.state_dict(destination=destination,
                            include_sublayers=include_sublayers,
                            structured_name_prefix=structured_name_prefix,
                            use_hook=use_hook)
        if not keep_vars:
            for k, v in d.items():
                if isinstance(v, Tensor):
                    d[k] = v.detach()
        return d

    def set_state_dict(self, state_dict, use_structured_name=True):
        """Load values by structured name into the existing leaves (a
        Parameter is written in place, so an optimizer built before keeps
        updating it). Returns (missing, unexpected) names; a shape that
        differs raises."""
        own = self.state_dict()
        missing, unexpected = [], []
        matched = {}
        for k, v in state_dict.items():
            if k in own:
                matched[k] = v
            else:
                unexpected.append(k)
        for k in own:
            if k not in matched:
                missing.append(k)
        for k, v in matched.items():
            target = own[k]
            raw = as_torch(v)
            if tuple(raw.shape) != tuple(target._value.shape):
                raise ValueError(
                    f"shape mismatch for {k}: {tuple(raw.shape)} vs "
                    f"{tuple(target._value.shape)}")
            with torch.no_grad():
                target._replace(raw.to(target._value.device,
                                       target._value.dtype))
        return missing, unexpected

    load_dict = set_state_dict
    set_dict = set_state_dict

    # -- dtype / device -----------------------------------------------------
    def to(self, device=None, dtype=None, blocking=None):
        if device is not None:
            from ..._core.tensor import Place
            if isinstance(device, Place):
                dev = torch.device("cpu") if device.is_cpu_place() else \
                    torch.device("cuda", device.gpu_device_id())
            else:
                d = str(device).replace("gpu", "cuda")
                dev = torch.device(d)
            self._move(lambda v: v.to(dev))
        if dtype is not None:
            self._to_dtype(_dt.convert_dtype(dtype))
        return self

    def _move(self, fn, floating_only=False):
        """Re-point every parameter's and buffer's tensor through `fn`
        (the leaves stay the same objects; grads are dropped)."""
        with torch.no_grad():
            for _, t in list(self.named_parameters()) + \
                    list(self.named_buffers()):
                if t is None or (floating_only and
                                 not t._value.is_floating_point()):
                    continue
                new = fn(t._value.detach())
                if isinstance(t, Parameter) or t._value.requires_grad:
                    t._value.grad = None
                    t._value.data = new
                else:
                    t._value = new
                t._grad_wrap = None

    def _to_dtype(self, d):
        self._move(lambda v: v.to(d), floating_only=True)
        for _, l in self.named_sublayers(include_self=True):
            l._dtype = d
        return self

    def astype(self, dtype):
        return self._to_dtype(_dt.convert_dtype(dtype))

    def float(self):
        return self._to_dtype(_dt.float32)

    def bfloat16(self):
        return self._to_dtype(_dt.bfloat16)

    def half(self):
        return self._to_dtype(_dt.float16)

    def clear_gradients(self, set_to_zero=True):
        for p in self.parameters():
            p.grad = None

    # -- functional bridge --------------------------------------------------
    def functional_state(self):
        """-> (params: {name: raw tensor}, buffers: {name: raw tensor})."""
        params = {n: p._value for n, p in self.named_parameters()}
        buffers = {n: b._value for n, b in self.named_buffers()
                   if b is not None}
        return params, buffers

    @contextlib.contextmanager
    def _swapped_state(self, params=None, buffers=None):
        """Run with these raw tensors in place of the named parameters and
        buffers; the Layer's own come back on exit."""
        saved = []
        try:
            if params:
                own = dict(self.named_parameters())
                for n, raw in params.items():
                    p = own[n]
                    saved.append((p, p._value))
                    p._value = raw
            if buffers:
                ownb = dict(self.named_buffers())
                for n, raw in buffers.items():
                    if n in ownb and ownb[n] is not None:
                        b = ownb[n]
                        saved.append((b, b._value))
                        b._value = raw
            yield
        finally:
            for t, old in saved:
                t._value = old

    def functional_call(self, params, buffers, *args, return_buffers=False,
                        **kwargs):
        """Pure call: forward with the given raw parameters and buffers;
        Tensors in the result come back as raw torch tensors."""
        with self._swapped_state(params, buffers):
            out = self(*args, **kwargs)
            result = _unwrap_tree(out)
            if return_buffers:
                new_buffers = {n: b._value for n, b in self.named_buffers()
                               if b is not None}
                return result, new_buffers
        return result


def _unwrap_tree(out):
    if isinstance(out, Tensor):
        return out._value
    if isinstance(out, (list, tuple)):
        return type(out)(_unwrap_tree(o) for o in out)
    if isinstance(out, dict):
        return {k: _unwrap_tree(v) for k, v in out.items()}
    return out
