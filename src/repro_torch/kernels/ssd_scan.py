"""The Mamba-2 SSD chunked scan: the hand-written CUDA kernel and its plain
PyTorch version.

Replaces ``src/repro/kernels/ssd_scan.py`` (``ssd_scan`` → ``_ssd_kernel``,
a Pallas TPU kernel whose grid ran the chunks of each (batch, head) in
order with the state in VMEM scratch).  :func:`ssd_scan` launches
``csrc/ssd_scan.cu`` for CUDA tensors and calls :func:`ssd_scan_plain` for
CPU tensors.  Both compute what the Pallas kernel computes, chunk by
chunk from a zero state, in float32:

    cs = cumsum(dt * A)
    y  = (C Bᵀ ∘ where(i >= j, exp(cs_i - cs_j), 0) ∘ dt_j) @ x
         + exp(cs) ∘ (C @ S)
    S ← exp(cs_L) S + Bᵀ (dt ∘ exp(cs_L - cs) ∘ x)

with B and C read from group ``h // (h / g)``, y returned in x's dtype and
the final state as (b, h, p, n) in float32.  ``chunk = min(chunk, s)`` as
in the reference; where s is not a multiple of it, the steps past s are
taken with dt = 0, which leaves the state as it was (exp(0 · A) = 1, and
no input enters), and their y is not returned.

For bfloat16 inputs the kernel runs the chunks in parallel on tensor
cores, with the state handed from chunk to chunk by a second launch
(three launches a call; :func:`cuda_launches`).  Its products are exact:
``C Bᵀ`` has two bfloat16 operands, and it takes each float32 operand of
the others (``W x``, ``C S``, ``Bᵀ (decay ∘ x)``) as three bfloat16
parts, which sum back to it.  So it computes the float32 function that
:func:`ssd_scan_plain` computes, in another summation order.  For
float32 inputs the kernel keeps its first design, CUDA-core FMAs.

The scan has a gradient (:class:`SSDScan`): the kernel's forward, and a
backward that differentiates :func:`ssd_scan_reference`, the torch
reference's chunked scan, recomputed from the saved inputs.  The JAX
package has no backward kernel either: it trains Mamba-2 through its
reference scan.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..core.errors import InvalidArgError
from . import ref
from ._cuda import DTYPE_CODES, CudaKernel, check_cuda_tensor, is_fake

MAX_CHUNK = 64               # the kernel's L x L tile of the decay matrix
MAX_STATE = 256              # B and C chunks of L x N in shared memory

KERNEL = CudaKernel(
    "ssd_scan", "ssd_scan.cu", "ssd_scan_launch",
    [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_void_p])

#: the kernel functions of a call, in launch order, by dtype
LAUNCHED = {torch.float32: ("ssd_scan_kernel",),
            torch.bfloat16: ("ssd_state_mma_kernel", "ssd_pass_kernel",
                             "ssd_output_mma_kernel")}


def cuda_launches(b: int, s: int, h: int, p: int, g: int, n: int,
                  chunk: int, dtype: torch.dtype):
    """The CUDA launches one call of the kernel makes with these shapes,
    as [(kernel function, blocks)], from the library's ``ssd_scan_plan``:
    the grids the launcher itself launches.  Builds and loads the
    library; empty where the call would launch nothing."""
    plan = KERNEL.function(
        "ssd_scan_plan", ctypes.c_int,
        [ctypes.c_int] * 8 + [ctypes.POINTER(ctypes.c_longlong)])
    blocks = (ctypes.c_longlong * 3)()
    count = plan(b, s, h, p, g, n, chunk, DTYPE_CODES[dtype], blocks)
    return list(zip(LAUNCHED[dtype][:count], blocks[:count]))


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, chunk: int = 64):
    """x: (b, s, h, p); dt: (b, s, h); A: (h,); B, C: (b, s, g, n) ->
    (y (b, s, h, p) in x's dtype, state (b, h, p, n) float32).

    The Pallas kernel's math in torch, all (b, h) at once, one chunk after
    another; the state is kept as the kernel's (n, p) scratch and returned
    transposed."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    dev = x.device
    f32 = torch.float32
    if s == 0:
        return (torch.empty((b, 0, h, p), dtype=x.dtype, device=dev),
                torch.zeros((b, h, p, n), dtype=f32, device=dev))
    L = min(chunk, s)
    nc = -(-s // L)
    pad = nc * L - s

    def heads_first(t, per_group=False):
        t = t.to(f32)
        if per_group and rep > 1:
            t = t.repeat_interleave(rep, dim=2)
        if pad:
            t = torch.cat([t, t.new_zeros((b, pad) + tuple(t.shape[2:]))], 1)
        return t.transpose(1, 2)               # (b, h, S, ...)

    xs, dts = heads_first(x), heads_first(dt)  # (b,h,S,p), (b,h,S)
    Bs, Cs = heads_first(B, True), heads_first(C, True)   # (b,h,S,n)
    Af = A.to(f32)[None, :, None]
    idx = torch.arange(L, device=dev)
    causal = idx[:, None] >= idx[None, :]
    zero = torch.zeros((), dtype=f32, device=dev)
    state = torch.zeros((b, h, n, p), dtype=f32, device=dev)
    ys = []
    for c in range(nc):
        sl = slice(c * L, (c + 1) * L)
        xc, dtc, Bc, Cc = xs[:, :, sl], dts[:, :, sl], Bs[:, :, sl], \
            Cs[:, :, sl]
        cs = torch.cumsum(dtc * Af, dim=-1)                     # (b,h,L)
        seg = cs[..., :, None] - cs[..., None, :]
        Lm = torch.where(causal, torch.exp(seg), zero)
        cb = torch.matmul(Cc, Bc.transpose(-1, -2))             # (b,h,L,L)
        w = cb * Lm * dtc[..., None, :]
        y = torch.matmul(w, xc)
        cstate = torch.matmul(Cc, state)                         # (b,h,L,p)
        y = y + torch.exp(cs)[..., None] * cstate
        decay_in = dtc * torch.exp(cs[..., -1:] - cs)
        bx = torch.matmul(Bc.transpose(-1, -2), decay_in[..., None] * xc)
        state = torch.exp(cs[..., -1])[..., None, None] * state + bx
        ys.append(y)
    y = torch.cat(ys, dim=2)[:, :, :s].transpose(1, 2).to(x.dtype)
    return y.contiguous(), state.transpose(-1, -2).contiguous()


def _ssd_scan_forward(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                      B: torch.Tensor, C: torch.Tensor, chunk: int):
    """The kernel for CUDA tensors (checked first; anything else raises),
    :func:`ssd_scan_plain` for CPU tensors."""
    tensors = (x, dt, A, B, C)
    if is_fake(*tensors):
        b, s, h, p = x.shape
        return torch.empty_like(x), torch.empty(
            (b, h, p, B.shape[3]), dtype=torch.float32, device=x.device)
    if all(t.device.type == "cpu" for t in tensors):
        return ssd_scan_plain(x, dt, A, B, C, chunk)
    if x.device.type != "cuda":
        raise InvalidArgError(f"ssd_scan: x is on {x.device}; the kernel "
                              f"runs on CUDA tensors, the plain version on "
                              f"CPU tensors")
    if x.dim() != 4 or B.dim() != 4:
        raise InvalidArgError(f"ssd_scan: x must be (b, s, h, p) and B, C "
                              f"(b, s, g, n); got {tuple(x.shape)}, "
                              f"{tuple(B.shape)}")
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if g == 0 or h % g or not 1 <= chunk <= MAX_CHUNK or n > MAX_STATE:
        raise InvalidArgError(
            f"ssd_scan: h={h}, g={g}, chunk={chunk}, n={n}; the kernel "
            f"needs h % g == 0, 1 <= chunk <= {MAX_CHUNK} and "
            f"n <= {MAX_STATE}")
    dev = x.device
    act = (torch.bfloat16,) if x.dtype == torch.bfloat16 else (torch.float32,)
    check_cuda_tensor("ssd_scan x", x, dev, act)
    check_cuda_tensor("ssd_scan dt", dt, dev, act, (b, s, h))
    check_cuda_tensor("ssd_scan A", A, dev, (torch.float32,), (h,))
    check_cuda_tensor("ssd_scan B", B, dev, act, (b, s, g, n))
    check_cuda_tensor("ssd_scan C", C, dev, act, (b, s, g, n))
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=dev)
    if b == 0 or s == 0 or h == 0 or p == 0 or n == 0:
        return y, torch.zeros((b, h, p, n), dtype=torch.float32, device=dev)
    if b > 65535 or h > 65535:
        raise InvalidArgError(f"ssd_scan: b={b}, h={h}; the kernel's grid "
                              f"takes at most 65535 of each")
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=dev)
    L = min(chunk, s)
    scratch = [None, None, None]
    if x.dtype == torch.bfloat16:
        # for the three launches: each chunk's own state contribution, the
        # state entering each chunk as its three bfloat16 parts (what the
        # tensor cores multiply), each chunk's cs_L
        nc = -(-s // L)
        scratch = [torch.empty((b, h, nc, p, n), dtype=torch.float32,
                               device=dev),
                   torch.empty((b, h, nc, 3, p, n), dtype=torch.bfloat16,
                               device=dev),
                   torch.empty((b, h, nc), dtype=torch.float32, device=dev)]
    KERNEL.launch(dev, x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                  B.data_ptr(), C.data_ptr(), y.data_ptr(), state.data_ptr(),
                  *(None if t is None else t.data_ptr() for t in scratch),
                  b, s, h, p, g, n, L, DTYPE_CODES[x.dtype])
    return y, state


def ssd_scan_reference(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       B: torch.Tensor, C: torch.Tensor, chunk: int = 64):
    """``ref.ssd_scan`` over any length s > 0, differentiable: the steps
    are padded to whole chunks with dt = 0, as the reference's model pads
    them (exp(0 · A) = 1 leaves the state as it was and no input enters),
    and the padded steps' y is dropped.  Returns (y (b, s, h, p), state
    (b, h, p, n) float32).  The ``use_kernels=False`` path, and what
    :class:`SSDScan`'s backward differentiates."""
    s = x.shape[1]
    pad = (-s) % chunk

    def padded(t):
        return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) if pad else t
    y, state = ref.ssd_scan(padded(x), padded(dt), A, padded(B), padded(C),
                            chunk=chunk, return_state=True)
    return y[:, :s], state


class SSDScan(torch.autograd.Function):
    """The scan with a gradient.

    forward: :func:`_ssd_scan_forward` (the kernel, or the plain version
    for CPU tensors); it saves x, dt, A, B and C.  backward: on detached
    copies of them, :func:`ssd_scan_reference` recomputed under grad mode
    and differentiated against the incoming gradients of y and of the
    final state (either may be None: an output that nothing used);
    autograd returns each gradient in its input's dtype."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk: int = 64):
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return _ssd_scan_forward(x, dt, A, B, C, chunk)

    @staticmethod
    def backward(ctx, dy, dstate):
        needs = ctx.needs_input_grad[:5]
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, needs)]
        wrt = [t for t in inputs if t.requires_grad]
        # with no step, or no output used, the inputs reach nothing
        if inputs[0].shape[1] and (dy is not None or dstate is not None):
            with torch.enable_grad():
                y, state = ssd_scan_reference(*inputs, chunk=ctx.chunk)
                outs = [(o, g) for o, g in ((y, dy), (state, dstate))
                        if g is not None]
                got = torch.autograd.grad([o for o, _ in outs], wrt,
                                          [g for _, g in outs],
                                          allow_unused=True)
        else:
            got = [None] * len(wrt)
        got = iter(got)
        grads = [None] * 5
        for i, t in enumerate(inputs):
            if t.requires_grad:
                g = next(got)
                grads[i] = torch.zeros_like(t) if g is None else g
        return (*grads, None)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, chunk: int = 64):
    """Shapes as :func:`ssd_scan_plain`.  The kernel takes x, dt, B and C
    all in bfloat16 (the served model) or all in float32, A in float32,
    contiguous, with g dividing h, 1 <= chunk <= :data:`MAX_CHUNK` and
    n <= :data:`MAX_STATE`; anything else raises.

    CUDA tensors go to the kernel; CPU tensors go to
    :func:`ssd_scan_plain`.  Differentiable in x, dt, A, B and C
    (:class:`SSDScan`)."""
    return SSDScan.apply(x, dt, A, B, C, chunk)


__all__ = ["KERNEL", "MAX_CHUNK", "MAX_STATE", "SSDScan", "cuda_launches",
           "ssd_scan", "ssd_scan_plain", "ssd_scan_reference"]
