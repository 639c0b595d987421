"""Workload models of the port, the JAX package's zoo: ``mnist`` (the
north star), ``cifar10``, ``lstm``, ``resnet`` (with a ResNet-50-class
depth), ``vgg``, ``transformer`` (dense or mixture-of-experts FFN) and
``tinymlp``. Each exposes ``init(seed)`` (a tree of
numpy arrays in the JAX package's layout), ``loss_fn(params, batch)``,
``batch_fn(seed)`` and a ``python -m kubeshare_tpu_torch.models.<name>``
CLI; ``common.run_training`` provides the timed loop."""

MODEL_NAMES = ("mnist", "cifar10", "lstm", "resnet", "vgg", "transformer",
               "tinymlp")


def get_model(name: str):
    """Return the model module for *name*."""
    import importlib

    if name not in MODEL_NAMES:
        raise ValueError(f"unknown model {name!r}; have {MODEL_NAMES}")
    return importlib.import_module(f".{name}", __package__)
