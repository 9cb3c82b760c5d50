"""Walk-step kernels for Hopper, each beside its plain PyTorch version.

- ``walk_step``    — flat-bias ITS step (replaces ``walk_step_pallas``)
- ``reject_step``  — counted-budget rejection step (``reject_step_pallas``)
- ``alias_step``   — O(1) alias-table step (``alias_step_pallas``)
- ``ref``          — the plain versions, and ``blocked_cumsum``

The CUDA sources live in ``csrc/`` and are built at first use
(``_build``); importing this package builds nothing.
"""
from repro_torch.kernels.alias_select import alias_step
from repro_torch.kernels.walk_step import reject_step, walk_step

KERNEL_WRAPPERS = (walk_step, reject_step, alias_step)


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


__all__ = [
    "alias_step",
    "reject_step",
    "walk_step",
    "launch_counts",
    "reset_launch_counts",
]
