"""Workload models of the port. Each exposes ``init(seed)`` (a tree of
numpy arrays in the JAX package's layout), ``loss_fn(params, batch)``,
``batch_fn(seed)`` and a ``python -m kubeshare_tpu_torch.models.<name>``
CLI; ``common.run_training`` provides the timed loop."""

MODEL_NAMES = ("mnist", "tinymlp", "transformer")


def get_model(name: str):
    """Return the model module for *name*."""
    import importlib

    if name not in MODEL_NAMES:
        raise ValueError(f"unknown model {name!r}; have {MODEL_NAMES}")
    return importlib.import_module(f".{name}", __package__)
