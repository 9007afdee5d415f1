"""Layer containers (counterpart of `paddle_tpu/nn/layer/container.py`)."""
from __future__ import annotations

from collections import OrderedDict

from ..._core.tensor import Parameter
from .layers import Layer


class Sequential(Layer):
    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], (list, tuple)) and \
                len(layers[0]) and isinstance(layers[0][0], (list, tuple)):
            for name, layer in layers[0]:
                self.add_sublayer(name, layer)
        elif len(layers) and isinstance(layers[0], tuple) and \
                isinstance(layers[0][0], str):
            for name, layer in layers:
                self.add_sublayer(name, layer)
        else:
            for i, layer in enumerate(layers):
                self.add_sublayer(str(i), layer)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return Sequential(*list(self._sub_layers.values())[idx])
        if isinstance(idx, str):
            return self._sub_layers[idx]
        keys = list(self._sub_layers.keys())
        return self._sub_layers[keys[idx]]

    def __setitem__(self, idx, layer):
        keys = list(self._sub_layers.keys())
        self._sub_layers[keys[idx]] = layer

    def __delitem__(self, idx):
        keys = list(self._sub_layers.keys())
        del self._sub_layers[keys[idx]]

    def __len__(self):
        return len(self._sub_layers)

    def __iter__(self):
        return iter(self._sub_layers.values())

    def forward(self, input):
        for layer in self._sub_layers.values():
            input = layer(input)
        return input


class LayerList(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            for i, l in enumerate(sublayers):
                self.add_sublayer(str(i), l)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return LayerList(list(self._sub_layers.values())[idx])
        keys = list(self._sub_layers.keys())
        return self._sub_layers[keys[idx]]

    def __setitem__(self, idx, layer):
        keys = list(self._sub_layers.keys())
        self._sub_layers[keys[idx]] = layer

    def __delitem__(self, idx):
        keys = list(self._sub_layers.keys())
        if isinstance(idx, slice):
            for k in keys[idx]:
                del self._sub_layers[k]
        else:
            del self._sub_layers[keys[idx]]
        # reindex
        layers = list(self._sub_layers.values())
        self._sub_layers.clear()
        for i, l in enumerate(layers):
            self._sub_layers[str(i)] = l

    def __len__(self):
        return len(self._sub_layers)

    def __iter__(self):
        return iter(self._sub_layers.values())

    def append(self, sublayer):
        self.add_sublayer(str(len(self)), sublayer)
        return self

    def insert(self, index, sublayer):
        layers = list(self._sub_layers.values())
        layers.insert(index, sublayer)
        self._sub_layers.clear()
        for i, l in enumerate(layers):
            self._sub_layers[str(i)] = l

    def extend(self, sublayers):
        for l in sublayers:
            self.append(l)
        return self


class LayerDict(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            self.update(sublayers)

    def __getitem__(self, key):
        return self._sub_layers[key]

    def __setitem__(self, key, layer):
        self.add_sublayer(key, layer)

    def __delitem__(self, key):
        del self._sub_layers[key]

    def __len__(self):
        return len(self._sub_layers)

    def __iter__(self):
        return iter(self._sub_layers)

    def __contains__(self, key):
        return key in self._sub_layers

    def clear(self):
        self._sub_layers.clear()

    def pop(self, key):
        l = self._sub_layers[key]
        del self._sub_layers[key]
        return l

    def keys(self):
        return self._sub_layers.keys()

    def items(self):
        return self._sub_layers.items()

    def values(self):
        return self._sub_layers.values()

    def update(self, sublayers):
        items = sublayers.items() if isinstance(sublayers, (dict, OrderedDict)) \
            else sublayers
        for k, v in items:
            self.add_sublayer(k, v)
        return self


class ParameterList(Layer):
    def __init__(self, parameters=None):
        super().__init__()
        if parameters is not None:
            for i, p in enumerate(parameters):
                self.add_parameter(str(i), p)

    def __getitem__(self, idx):
        keys = list(self._parameters.keys())
        return self._parameters[keys[idx]]

    def __setitem__(self, idx, param):
        self._parameters[str(idx)] = param

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters.values())

    def append(self, parameter):
        self.add_parameter(str(len(self)), parameter)
        return self
