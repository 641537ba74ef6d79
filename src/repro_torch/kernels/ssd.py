"""Wrapper of the CUDA SSD intra-chunk kernel (``csrc/ssd.cu``), kernel 6.

Replaces the TPU kernel ``repro/kernels/ssd.py::ssd_intra_block``: the
Mamba2 intra-chunk term ``(tril(exp(segsum(da))) ∘ C Bᵀ) · x`` of every
(batch·chunk, head) block. The wrapper takes CUDA tensors only —
``kernels.ops`` routes CPU tensors to ``kernels.ref.ssd_intra_ref``.

The kernel reads its operands through element strides, so the model passes
views of its own tensors (:func:`kernel_strides` says what it accepts), and
the output is a ``(G, H, lc, P)`` view of a ``(G, lc, H, P)`` buffer: the
model's ``(B, S, H, P)`` layout, which it reads back without a copy.

``launches`` counts the kernel launches of this process (reset it to 0 to
count a window).

:func:`ssd_intra_autograd` gives the kernel a gradient for training
(:class:`SsdIntraFunction`): the forward launches the kernel, the backward
is the plain PyTorch VJP ``kernels.ref.ssd_intra_vjp``. The backward is
not a kernel because the TPU kernel has none to port: the JAX package
trains through the jnp einsum, not through its Pallas kernel
(``repro/models/ssm.py`` sets ``USE_PALLAS_INTRA = False`` and
differentiates the einsum chain of ``ssd_chunked``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import build, ref

__all__ = ["ssd_intra", "ssd_intra_with", "ssd_intra_autograd",
           "ssd_intra_sharded", "SsdIntraFunction", "bind", "kernel_strides",
           "launches"]

launches = 0

_SMEM_LIMIT = 227 * 1024    # dynamic shared memory one H100 block can use


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from ``csrc/ssd.cu`` (or
    from an edited copy of it, as ``tools/kernel_variants.py`` builds)."""
    lib.ssd_intra_launch.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    lib.ssd_intra_launch.restype = ctypes.c_int
    lib.ssd_intra_smem_bytes.argtypes = [ctypes.c_int]
    lib.ssd_intra_smem_bytes.restype = ctypes.c_longlong
    return lib


@functools.lru_cache(maxsize=None)
def _lib():
    return bind(build.library("ssd"))


def kernel_strides(c_mat: torch.Tensor, b_mat: torch.Tensor, da: torch.Tensor,
                   x: torch.Tensor, out: torch.Tensor) -> Tuple[int, ...]:
    """The 13 element strides the kernel takes, in its order: C (g, l),
    B (g, l), da (g, h, l), x (g, h, l), out (g, h, l).

    C, B, x and out must have unit stride over their last dimension (a
    dimension of size 1 has none to speak of); da may have any strides.
    """
    for name, t in (("c_mat", c_mat), ("b_mat", b_mat), ("x", x),
                    ("out", out)):
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"{name} must have unit stride over its last "
                             f"dimension, got strides {t.stride()}")
    return (*c_mat.stride()[:2], *b_mat.stride()[:2], *da.stride(),
            *x.stride()[:3], *out.stride()[:3])


def _check(name: str, t: torch.Tensor, ndim: int, device) -> None:
    if t.device.type != "cuda" or t.device != device:
        raise ValueError(f"{name} must be a CUDA tensor on {device}, got "
                         f"{t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape "
                         f"{tuple(t.shape)}")


def ssd_intra(c_mat: torch.Tensor, b_mat: torch.Tensor, da: torch.Tensor,
              x: torch.Tensor) -> torch.Tensor:
    """(G, lc, N) C and B, (G, H, lc) da, (G, H, lc, P) x → (G, H, lc, P),
    returned as the ``transpose(1, 2)`` view of a (G, lc, H, P) buffer."""
    return ssd_intra_with(None, c_mat, b_mat, da, x)


def ssd_intra_with(lib, c_mat: torch.Tensor, b_mat: torch.Tensor,
                   da: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """:func:`ssd_intra` launched from ``lib``, a library bound by
    :func:`bind` (None: the port's own)."""
    global launches
    device = c_mat.device
    _check("c_mat", c_mat, 3, device)
    _check("b_mat", b_mat, 3, device)
    _check("da", da, 3, device)
    _check("x", x, 4, device)
    g, lc, n = c_mat.shape
    h, p = da.shape[1], x.shape[-1]
    if (b_mat.shape != c_mat.shape or da.shape != (g, h, lc)
            or x.shape != (g, h, lc, p)):
        raise ValueError(
            f"shape mismatch: c_mat {tuple(c_mat.shape)}, b_mat "
            f"{tuple(b_mat.shape)}, da {tuple(da.shape)}, x {tuple(x.shape)}")
    out = torch.empty((g, lc, h, p), dtype=torch.float32,
                      device=device).transpose(1, 2)
    strides = kernel_strides(c_mat, b_mat, da, x, out)
    if out.numel() == 0:
        return out
    if n == 0:
        return out.zero_()          # an empty score sum is 0
    if lib is None:
        lib = _lib()
    if lib.ssd_intra_smem_bytes(lc) > _SMEM_LIMIT:
        raise ValueError(f"chunk length {lc} exceeds the kernel's shared "
                         "memory for its score strip (at most 256)")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.ssd_intra_launch(
            c_mat.data_ptr(), b_mat.data_ptr(), da.data_ptr(), x.data_ptr(),
            out.data_ptr(), (ctypes.c_longlong * 13)(*strides), g, h, lc, n,
            p, stream)
    if err != 0:
        raise RuntimeError(f"ssd_intra launch failed: cudaError {err}")
    launches += 1
    return out


class SsdIntraFunction(torch.autograd.Function):
    """Kernel 6 with a gradient: ``apply(c_mat, b_mat, da, x, forward)``
    runs ``forward`` (the CUDA wrapper :func:`ssd_intra` on the card; the
    CPU tests inject the plain version) and differentiates with
    ``ref.ssd_intra_vjp`` in plain PyTorch. Under ``torch.no_grad()`` it
    saves nothing and costs nothing beyond the forward."""

    @staticmethod
    def forward(ctx, c_mat, b_mat, da, x, forward):
        ctx.save_for_backward(c_mat, b_mat, da, x)
        return forward(c_mat, b_mat, da, x)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        return (*ref.ssd_intra_vjp(*ctx.saved_tensors, dy), None)


def ssd_intra_autograd(c_mat: torch.Tensor, b_mat: torch.Tensor,
                       da: torch.Tensor, x: torch.Tensor,
                       forward=None) -> torch.Tensor:
    """:func:`ssd_intra` (or ``forward``) differentiable in all four
    inputs."""
    return SsdIntraFunction.apply(c_mat, b_mat, da, x, forward or ssd_intra)


def ssd_intra_sharded(c_mat, b_mat, da, x):
    """Kernel 6 on DTensors, through ``local_map``: each rank runs
    :func:`ssd_intra_autograd` on its own block, with no communication
    beyond placing the inputs at the reference's placements
    (``repro/models/ssm.py:194-198``): C and B (G, lc, N) with G over
    ``data`` and replicated over ``model``, da (G, H, lc) and x (G, H, lc,
    P) with G over ``data`` and the heads over ``model`` (an axis that does
    not divide its dim is dropped). The output lies as x. On the card each
    rank launches the kernel; on CPU tensors the same Function runs the
    plain version, with the same plain backward."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.launch.shardings import fitted_placements

    mesh = c_mat.device_mesh

    def placed(spec, t):
        return fitted_placements(spec, t.shape, mesh)

    cb = placed(("data", None, None), c_mat)
    xs = placed(("data", "model", None, None), x)
    das = placed(("data", "model", None), da)
    # A rank's dC and dB sum over its own heads only: partial sums over
    # the mesh dims the heads are sharded over.
    cb_grad = [Partial() if c.is_replicate() and h.is_shard(1) else c
               for c, h in zip(cb, xs)]
    forward = ssd_intra if c_mat.is_cuda else ref.ssd_intra_ref
    return local_map(
        lambda c, b, a, xx: ssd_intra_autograd(c, b, a, xx, forward),
        out_placements=xs, in_placements=(cb, cb, das, xs),
        in_grad_placements=(cb_grad, cb_grad, das, xs),
        device_mesh=mesh, redistribute_inputs=True)(c_mat, b_mat, da, x)
