"""Device selection, the storage dtypes and the float32 precision policy.

Counterpart of the JAX CLI's ``--platform`` pin (``demethify_tpu/cli.py``)
and the backend routing in ``demethify_tpu/solvers/api.py``: here the
device is always named explicitly, and asking for ``cuda`` without a GPU
raises instead of falling back to the CPU.

``--dtype`` names the STORAGE dtype of Y, D and R. float32 and float64
store and compute in the same dtype; bfloat16 stores the three data
arrays in bf16 while u, alpha, the solver's scalars and every sum over the
CpG axis stay in float32 (``state_dtype``), as the JAX package's
``accum_dtype`` has it.
"""

import torch

# TF32 keeps about three decimal digits. The solver's float32 trajectory is
# compared with the JAX reference and the Gram-identity cost already loses
# digits to cancellation at megabase scale, so no product in this package
# may silently run in TF32: matmuls and cuDNN both stay in full float32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DEVICES = ("cuda", "cpu")
DTYPES = {"float32": torch.float32, "float64": torch.float64,
          "bfloat16": torch.bfloat16}


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
    """``--dtype`` -> the storage dtype of Y, D and R."""
    if name not in DTYPES:
        raise ValueError(f"unsupported dtype {name!r}; expected one of "
                         f"{tuple(DTYPES)}")
    return DTYPES[name]


def state_dtype(storage: torch.dtype) -> torch.dtype:
    """The dtype of the solver state and of every sum over the CpG axis
    for data stored in ``storage``: 16-bit storage accumulates in float32;
    float32 and float64 stay as they are."""
    if storage in (torch.bfloat16, torch.float16):
        return torch.float32
    return storage
