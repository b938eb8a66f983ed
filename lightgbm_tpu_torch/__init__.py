"""lightgbm_tpu_torch — the PyTorch/CUDA port of lightgbm_tpu.

A second package beside the JAX one, mirroring its layout and names.
This slice covers serial-learner GBDT training on dense numerical data
and batch predict: ``Dataset`` -> bin mappers -> binned matrix on the
device -> gradients -> best-first tree growth -> score update -> model
text -> predict, with row sampling (bagging, GOSS, MVS), validation sets
scored on the device, metrics, callbacks, early stopping and ``cv``.
The histogram, best-split, leaf-lookup and sampling passes run as
hand-written CUDA kernels for Hopper (``csrc/``, built with nvcc at
first use); each has a plain PyTorch version beside it, which the CPU
path uses.  Training and predict run on the card (``device_type=cuda``,
the default) unless ``device_type=cpu`` is passed; without a card the
default raises.  The package imports nothing of JAX or of
``lightgbm_tpu``.
"""
from .config import Config
from .utils.log import Log, LightGBMError

__version__ = "0.1.0"

__all__ = ["Config", "Log", "LightGBMError", "Dataset", "Booster", "train",
           "cv", "CVBooster", "early_stopping", "print_evaluation",
           "record_evaluation", "reset_parameter", "__version__"]


def __getattr__(name):
    # the API surface imports torch; keep `import lightgbm_tpu_torch` cheap
    if name in ("Dataset", "Booster"):
        from . import basic
        return getattr(basic, name)
    if name in ("train", "cv", "CVBooster"):
        from . import engine
        return getattr(engine, name)
    if name in ("early_stopping", "print_evaluation", "record_evaluation",
                "reset_parameter"):
        from . import callback
        return getattr(callback, name)
    raise AttributeError(
        f"module 'lightgbm_tpu_torch' has no attribute {name!r}")
