"""The port's segment extraction (plain version of kernel 5) against the JAX
package's Pallas ``extract_codes`` in interpret mode, on the CPU.

Mirrors ``tests/test_kernels.py``'s bitpack tests: S ∈ {8, 16, 32}, mixed
and zero widths, odd sizes. Integer arithmetic: results must be equal.
Segments reach the port as it stores them: ``torch.uint8`` / ``torch.uint16``
and, for S = 32, the int32 bit pattern of the uint32 words.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import segments as jax_segments  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402

from repro_torch.core import segments  # noqa: E402
from repro_torch.kernels import bitpack, ops, ref  # noqa: E402


def _as_tensor(packed: np.ndarray) -> torch.Tensor:
    if packed.dtype == np.uint32:
        packed = packed.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(packed))


def _codes(rng, bits, n):
    return np.stack([rng.integers(0, 1 << b, size=n) if b
                     else np.zeros(n, np.int64) for b in bits], axis=1)


def _check(bits, seg_bits, codes):
    layout = segments.build_layout(bits, seg_bits=seg_bits)
    packed = segments.pack_codes(layout, codes)
    jax_layout = jax_segments.build_layout(bits, seg_bits=seg_bits)
    np.testing.assert_array_equal(
        packed, jax_segments.pack_codes(jax_layout, codes))
    want = np.asarray(jax_ops.extract_codes(jnp.asarray(packed), jax_layout,
                                            interpret=True))
    seg = _as_tensor(packed)
    assert seg.dtype == bitpack.SEG_DTYPES[seg_bits]
    got = ref.extract_ref(seg, layout)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), codes)
    np.testing.assert_array_equal(ops.extract_codes(seg, layout).numpy(), want)


@pytest.mark.parametrize("seg_bits", [8, 16, 32])
def test_extract_matches_pallas_roundtrip(seg_bits):
    rng = np.random.default_rng(seg_bits)
    bits = rng.integers(0, 10, size=24).tolist()
    bits[0] = max(bits[0], 1)
    _check(bits, seg_bits, _codes(rng, bits, 700))


@pytest.mark.parametrize("seg_bits", [8, 16, 32])
def test_extract_matches_pallas_odd_sizes(seg_bits):
    bits = [3, 9, 1, 7, 12]
    _check(bits, seg_bits, _codes(np.random.default_rng(1), bits, 13))


@pytest.mark.parametrize("seed", range(6))
def test_extract_matches_pallas_mixed_widths(seed):
    rng = np.random.default_rng(seed)
    d = int(rng.integers(1, 16))
    bits = rng.integers(0, 11, size=d).tolist()
    if sum(bits) == 0:
        bits[0] = 1
    seg_bits = int(rng.choice([8, 16, 32]))
    _check(bits, seg_bits, _codes(rng, bits, int(rng.integers(1, 150))))


def test_extract_reads_the_high_bit_of_32_bit_words():
    """A uint32 word with its top bit set arrives as a negative int32."""
    bits = [16, 16, 31, 1]
    codes = np.array([[0xFFFF, 0x8000, (1 << 31) - 1, 1],
                      [0x8001, 0, 1 << 30, 0]])
    _check(bits, 32, codes)


@pytest.mark.parametrize("seg_bits", [8, 16, 32])
def test_kernel_plan_table_lists_the_layout_pieces(seg_bits):
    """The table kernel 5 reads: each dim's (seg, rshift, nbits, lshift)
    pieces in order, one upload per (bit widths, S, device)."""
    bits = [3, 9, 0, 7, 12, 1]
    layout = segments.build_layout(bits, seg_bits=seg_bits)
    pieces, starts = bitpack._plan(layout.bits, seg_bits, torch.device("cpu"))
    want = [(pc.seg, pc.rshift, pc.nbits, pc.lshift)
            for plan in layout.plans for pc in plan]
    assert pieces.dtype == starts.dtype == torch.int32
    assert [tuple(row) for row in pieces.tolist()] == want
    assert starts.tolist() == np.cumsum(
        [0] + [len(plan) for plan in layout.plans]).tolist()
    again = segments.build_layout(bits, seg_bits=seg_bits)
    assert bitpack._plan(again.bits, seg_bits, torch.device("cpu"))[0] is pieces
