"""The eager core: dtypes, interpreter state, Tensor and backward."""
