"""The wide ``its_select`` kernel's split scan (``kernels.ref.chunked_cumsum``:
chunks of 4,096 entries scanned on their own, joined by a small table a
row) against the scan of the whole row (``kernels.ref.padded_cumsum``) and
XLA-CPU's ``jnp.cumsum``, bit for bit; and its split of the rows' 16-block
envelope (``_chunked_envelope``, a plain mirror of the kernels') against
the envelope of the whole row.

The card kernel runs this split; ``test_torch_cuda.py`` holds it against
the plain version on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

from repro_torch.kernels import ref  # noqa: E402

WIDTHS = [4095, 4096, 4097, 65_535, 65_537, 102_784, 821_376]


def _bits(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).view(np.uint32)


def _rows(width: int, kind: str) -> np.ndarray:
    """A few rows: values over 2^±8 with some zeros (``random``), or rows
    whose 16-blocks start with zero biases and a long run of zeros
    (``step_down``), where the CTPS steps down at a 16-block."""
    rng = np.random.default_rng(width + len(kind))
    n = 3 if width > 100_000 else 4
    x = rng.random((n, width)) * np.exp2(rng.uniform(-8, 8, (n, width)))
    if kind == "random":
        x[rng.random(x.shape) < 0.1] = 0.0
    else:
        x[:, 16::16] = 0.0
        x[0, width // 5: width // 2] = 0.0
    return x.astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "step_down"])
@pytest.mark.parametrize("width", WIDTHS)
def test_chunked_cumsum_equals_padded_cumsum_and_jnp_cumsum(width, kind):
    x = _rows(width, kind)
    got = ref.chunked_cumsum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(ref.padded_cumsum(torch.from_numpy(x)).numpy()))
    np.testing.assert_array_equal(_bits(got), _bits(jnp.cumsum(jnp.asarray(x), axis=-1)))
    # the row total the rounds kernel divides by is the last prefix
    np.testing.assert_array_equal(_bits(got[:, -1]), _bits(np.asarray(jnp.cumsum(x, axis=-1))[:, -1]))
    if kind == "step_down" and width > 4096:
        assert (np.diff(got, axis=-1) < 0).any(), "the input should make the CTPS step down"


def _chunked_envelope(sums: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The 16-block envelope of ``(n, P)`` CTPS rows as the wide kernel
    splits it: ``pm[b]``, the largest last entry of blocks ``0..b``, and
    ``sm[b]``, the smallest first entry of blocks ``b..nb-1`` (the
    kernels' ``exact_count``).  Phase C takes the runs inside each chunk's
    256 blocks; the rounds kernel scans the chunks' extremes and combines."""
    n, p = sums.shape
    nb = -(-p // ref.SCAN_BLOCK)
    w3 = -(-p // ref.CHUNK)
    starts = torch.arange(nb) * ref.SCAN_BLOCK
    first = sums[:, starts]
    last = sums[:, torch.clamp(starts + ref.SCAN_BLOCK - 1, max=p - 1)]
    pad = w3 * 256 - nb
    last = torch.nn.functional.pad(last, (0, pad), value=-float("inf")).reshape(n, w3, 256)
    first = torch.nn.functional.pad(first, (0, pad), value=float("inf")).reshape(n, w3, 256)
    pml = torch.cummax(last, dim=-1).values
    sml = torch.flip(torch.cummin(torch.flip(first, (-1,)), dim=-1).values, (-1,))
    cpm = torch.cummax(pml[..., -1], dim=-1).values
    csm = torch.flip(torch.cummin(torch.flip(sml[..., 0], (-1,)), dim=-1).values, (-1,))
    before = torch.nn.functional.pad(cpm, (1, 0), value=-float("inf"))[:, :w3, None]
    after = torch.nn.functional.pad(csm, (0, 1), value=float("inf"))[:, 1:, None]
    pm = torch.maximum(pml, before).reshape(n, -1)[:, :nb]
    sm = torch.minimum(sml, after).reshape(n, -1)[:, :nb]
    return pm, sm


@pytest.mark.parametrize("width", WIDTHS)
def test_chunked_envelope_equals_the_whole_rows_envelope(width):
    x = _rows(width, "step_down")
    sums = ref.padded_cumsum(torch.from_numpy(x))
    ctps = sums / torch.clamp(sums[:, -1:], min=1e-12)
    nb = -(-width // ref.SCAN_BLOCK)
    starts = torch.arange(nb) * ref.SCAN_BLOCK
    last = ctps[:, torch.clamp(starts + ref.SCAN_BLOCK - 1, max=width - 1)]
    want_pm = torch.cummax(last, dim=-1).values
    want_sm = torch.flip(torch.cummin(torch.flip(ctps[:, starts], (-1,)), dim=-1).values, (-1,))
    pm, sm = _chunked_envelope(ctps)
    np.testing.assert_array_equal(_bits(pm.numpy()), _bits(want_pm.numpy()))
    np.testing.assert_array_equal(_bits(sm.numpy()), _bits(want_sm.numpy()))
    # on a row that steps down, the envelope is what tells the count of
    # entries <= r from a binary search's answer
    if width > 4096:
        assert (sm[:, 1:] < pm[:, :-1]).any()
