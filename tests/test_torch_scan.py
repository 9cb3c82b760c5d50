"""The compact scan rule of the ``walk_step_window`` kernel
(``kernels.ref.compact_window_scan``: only the 16-blocks a row touches, the
total from the top level) against the scan of the whole zero-filled window
(``kernels.ref.padded_cumsum``, XLA-CPU's association), bit for bit.

The card kernel runs this rule per walker; ``test_torch_cuda.py`` holds it
against the plain version on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

from repro_torch.kernels import ref  # noqa: E402


def _spread(rng, n: int, sign: str) -> np.ndarray:
    """Values over 2^±20, so that association shows; some zeros; with
    ``sign == "mixed"`` some negative (the kernel counts, it does not search)."""
    vals = rng.random(n) * np.exp2(rng.uniform(-20.0, 20.0, n))
    vals[rng.random(n) < 0.1] = 0.0
    if sign == "mixed":
        vals[rng.random(n) < 0.3] *= -1.0
    return vals.astype(np.float32)


def _assert_equals_full_window(vals: np.ndarray, local: int, seg: int) -> None:
    win = np.zeros(2 * seg, np.float32)
    win[local:local + vals.shape[0]] = vals
    cum = ref.padded_cumsum(torch.from_numpy(win)[None])[0].numpy()
    pre, total = ref.compact_window_scan(vals, local, seg)
    np.testing.assert_array_equal(pre.view(np.uint32), cum[local:local + vals.shape[0]].view(np.uint32),
                                  err_msg=f"local={local} deg={vals.shape[0]}")
    assert np.float32(total).view(np.uint32) == cum[-1].view(np.uint32), (local, vals.shape[0])


@pytest.mark.parametrize("sign", ["positive", "mixed"])
@pytest.mark.parametrize("deg", [1, 15, 16, 17, "seg"])
@pytest.mark.parametrize("seg", [128, 512])
def test_compact_scan_equals_full_window_scan(seg, deg, sign):
    deg = seg if deg == "seg" else deg
    rng = np.random.default_rng(seg + deg + (sign == "mixed"))
    starts = set(range(16)) | set(range(seg - 16, seg))  # every local % 16, near both ends
    if seg > 128:  # rows that end at, cross and start at the group edge at 256
        starts |= {256 - deg, 257 - deg, 240, 248, 255, 256} | set(range(240 - deg, 256 - deg))
    for local in sorted(x for x in starts if 0 <= x < seg):
        _assert_equals_full_window(_spread(rng, deg, sign), local, seg)


@pytest.mark.parametrize("seg", [128, 256, 384, 512])
def test_compact_scan_equals_full_window_scan_on_random_rows(seg):
    rng = np.random.default_rng(seg)
    for _ in range(150):
        local, deg = int(rng.integers(0, seg)), int(rng.integers(1, seg + 1))
        _assert_equals_full_window(_spread(rng, deg, "positive"), local, seg)


def test_total_is_the_top_level_value_not_the_last_prefix():
    """seg = 512: a row with mass g0 = 1 in group 0's last block, s = 2^-24
    in group 1's first block and t = 2^-24 in its second.  The last prefix
    is t + (s + g0) = 1 (two ties to even); the total is g0 + (s + t) =
    1 + 2^-23.  Taking the last prefix as the total fails here."""
    seg, local = 512, 240
    vals = np.zeros(33, np.float32)
    vals[0], vals[16], vals[32] = 1.0, 2.0 ** -24, 2.0 ** -24
    pre, total = ref.compact_window_scan(vals, local, seg)
    assert pre[-1] == np.float32(1.0)
    assert total == np.float32(1.0 + 2.0 ** -23)
    _assert_equals_full_window(vals, local, seg)
