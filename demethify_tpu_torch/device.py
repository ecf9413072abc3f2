"""Device selection and the float32 precision policy.

Counterpart of the JAX CLI's ``--platform`` pin (``demethify_tpu/cli.py``)
and the backend routing in ``demethify_tpu/solvers/api.py``: here the
device is always named explicitly, and asking for ``cuda`` without a GPU
raises instead of falling back to the CPU.
"""

import torch

# TF32 keeps about three decimal digits. The solver's float32 trajectory is
# compared with the JAX reference and the Gram-identity cost already loses
# digits to cancellation at megabase scale, so no product in this package
# may silently run in TF32: matmuls and cuDNN both stay in full float32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DEVICES = ("cuda", "cpu")
DTYPES = {"float32": torch.float32, "float64": torch.float64}


def resolve_device(name: str) -> torch.device:
    """``"cuda"`` or ``"cpu"`` -> ``torch.device``. Raises RuntimeError for
    ``"cuda"`` when no GPU is visible; never falls back."""
    if name not in DEVICES:
        raise ValueError(f"unknown device {name!r}; expected one of "
                         f"{DEVICES}")
    if name == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' was requested but torch sees no GPU "
                "(torch.cuda.is_available() is False); pass --device cpu "
                "to run the plain PyTorch path")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def resolve_dtype(name: str) -> torch.dtype:
    if name not in DTYPES:
        raise ValueError(f"unsupported dtype {name!r}; expected one of "
                         f"{tuple(DTYPES)} (bfloat16 storage is ROADMAP "
                         f"port queue item 9)")
    return DTYPES[name]
