"""K1's, K4's and K7's launch plan on the card: the launchers take the
layout's shared bytes, the state region's flag and rows, the row buffer's
rows and K4's member group from the kernel library's exports (the
kernels' own copy of the plan), and a failed launch names its case.

The library exists only where nvcc and a card do; here a stand-in with
the exports' names records how the plan reads them. ``chip_smoke.py``'s
``phase_layouts`` holds the Python plan to the real exports on the card.
"""

import pytest
import torch

from demethify_tpu_torch.ops import _build, cuda_kernels
from demethify_tpu_torch.ops.cuda_kernels import (
    SMEM_LIMIT,
    launch_case,
    lib_smem,
    u_phase_layout,
    u_phase_smem,
)


class _Exports:
    """The ``*_smem`` exports of one kernel's three layouts, each giving
    fixed bytes and recording its arguments."""

    def __init__(self, prefix, nbytes):
        self.calls = []
        for suffix, layout in (("", "resident"), ("_wide", "wide"),
                               ("_global", "global")):
            setattr(self, f"{prefix}{suffix}_smem",
                    self._export(layout, nbytes[layout]))

    def _export(self, layout, n):
        def smem(*args):
            self.calls.append((layout, args))
            return n
        return smem


@pytest.mark.parametrize("nbytes,want", [
    ({"resident": 1000, "wide": 900, "global": 10}, "resident"),
    ({"resident": SMEM_LIMIT + 1, "wide": 900, "global": 10}, "wide"),
    ({"resident": SMEM_LIMIT + 1, "wide": SMEM_LIMIT + 1, "global": 10},
     "global"),
], ids=["resident", "wide", "global"])
def test_layout_follows_the_library_bytes(nbytes, want):
    """The layout rule reads each layout's bytes from the library's
    exports, with the arguments as ints, whatever the Python copy says."""
    lib = _Exports("dm_u_phase_grams", nbytes)
    layout, smem = u_phase_layout(
        "u_phase_grams", 8, 10, 5, 1, False, False,
        smem=lib_smem(lib, "dm_u_phase_grams", 8, 10, 5, 1, False, False))
    assert (layout, smem) == (want, nbytes[want])
    assert all(args == (8, 10, 5, 1, 0, 0) for _, args in lib.calls)
    assert u_phase_layout("u_phase_grams", 8, 10, 5, 1)[0] == "resident"


def test_k4_layout_reads_its_own_exports():
    lib = _Exports("dm_u_phase_grams_multi",
                   {"resident": SMEM_LIMIT + 1, "wide": 500, "global": 10})
    got = u_phase_layout(
        "u_phase_grams_multi", 4, 64, 25, 4, weighted=True,
        smem=lib_smem(lib, "dm_u_phase_grams_multi", 4, 64, 25, 4, True))
    assert got == ("wide", 500)
    assert all(args == (4, 64, 25, 4, 1) for _, args in lib.calls)


def test_default_bytes_are_the_python_plan():
    """Without a library (the CPU plans and tests) the rule reads
    ``u_phase_smem``."""
    for n_s, n_ct, n_u in ((10, 5, 1), (100, 25, 4), (10, 200, 12)):
        layout, smem = u_phase_layout("k", 8, n_s, n_ct, n_u)
        assert smem == u_phase_smem(layout, 8, n_s, n_ct, n_u)


def test_failed_launch_names_its_case():
    case = launch_case(1_000_000, 10, 5, 12, 4, torch.bfloat16,
                       torch.float32, "global", True, 33024, weighted=True,
                       lagged=False)
    with pytest.raises(RuntimeError) as err:
        _build.check(1, "u_phase_grams_multi", case)
    msg = str(err.value)
    for part in ("u_phase_grams_multi", "error 1", "N = 1000000",
                 "n_s = 10", "n_ct = 5", "n_u = 12", "B = 4",
                 "bfloat16 data", "float32 state", "global layout",
                 "state region in device memory: True",
                 "33024 bytes of shared memory", "weighted"):
        assert part in msg
    assert "lagged" not in msg
    _build.check(0, "u_phase_grams", case)          # success: no raise


def test_k7_refuses_past_the_limit_stating_the_bytes():
    assert cuda_kernels.k7_smem(8, 225) == 8 * 225 * 129
    with pytest.raises(NotImplementedError, match="233232 bytes"):
        cuda_kernels.k7_smem(8, 226)
