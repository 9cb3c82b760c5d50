"""Walk-step and selection kernels for Hopper, each beside its plain
PyTorch version.

- ``walk_step``        — flat-bias ITS step, every ITS cohort in one launch
  (replaces ``walk_step_pallas``)
- ``walk_step_window`` — window-bias ITS step (``walk_step_window_pallas``)
- ``reject_step``      — counted-budget rejection step, every rejection
  cohort in one launch (``reject_step_pallas``)
- ``alias_step``       — O(1) alias-table step, every alias cohort and the
  tail in one launch (``alias_step_pallas``)
- ``its_select``       — K-of-P ITS selection with region search
  (``its_select_pallas``): a warp kernel for K <= 32 and P <= 4096, a wide
  kernel for any other K and P
- ``ref``              — the plain versions, and the scan rule
- ``ops``              — ``its_select`` and ``walk_step`` drawing their own
  uniforms from a key, as ``repro.kernels.ops``
- ``threefry``         — the counted-RNG hash the step kernels run per
  walker, in PyTorch; ``hash_uniform``, the device hash alone; and
  ``derive_keys``, the per-row keys of a batch of rows (``RowKeys``)

The CUDA sources live in ``csrc/`` and are built at first use
(``_build``); importing this package builds nothing.
"""
from repro_torch.kernels.alias_select import alias_step
from repro_torch.kernels.its_select import its_select
from repro_torch.kernels.threefry import derive_keys
from repro_torch.kernels.walk_step import reject_step, walk_step, walk_step_window

KERNEL_WRAPPERS = (walk_step, reject_step, alias_step, walk_step_window, its_select, derive_keys)


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
    its_select.wide_launches = 0


__all__ = [
    "alias_step",
    "derive_keys",
    "its_select",
    "reject_step",
    "walk_step",
    "walk_step_window",
    "launch_counts",
    "reset_launch_counts",
]
