"""Distributed real FFTs over a device mesh.

JAX replacement for the reference's ``mpi4py-fft`` layer
(``FFTMPI2D/3D``, /root/reference/sopht_mpi/numeric/eulerian_grid_ops/
poisson_solver_2d/fft_mpi_2d.py, poisson_solver_3d/fft_mpi_3d.py), which
wraps FFTW with MPI all-to-all transposes. Here each device runs local
XLA FFTs along its unsharded axes and ``lax.all_to_all`` (NCCL between
GPUs) performs the pencil transposes, all inside ``shard_map`` so the whole
pipeline lives in one jitted SPMD program.

Layouts (see parallel/mesh.py for grid conventions):

2D real field (Ny, Nx) sharded P('y', 'x') with mesh ('y','x'):
    slab (px == 1): rfft(x, local) -> pad x-freq to multiple of py ->
    all_to_all over 'y' (split x-freq, concat y) -> fft(y, local).
    Fourier layout: (Ny, Fxp) complex, sharded P('x', 'y').
    pencil (px > 1; EXCEEDS the reference, whose 2D solver rejects >1
    distributed dim, UnboundedPoissonSolverMPI2D.py:180-186): all_to_all
    over 'x' first gathers the full x axis (split y) -> rfft(x, local) ->
    pad x-freq to a multiple of px*py -> all_to_all over 'x' then 'y'
    (split x-freq, concat y twice) -> fft(y, local).
    Fourier layout: (Ny, Fxp) complex, sharded P(None, ('x', 'y'))
    (x-freq split x-major / y-minor by the transpose order).

3D real field (Nz, Ny, Nx) sharded P('z','y',None) with mesh ('z','y'):
    rfft(x, local) -> pad x-freq to multiple of py -> all_to_all over 'y' ->
    fft(y, local) -> all_to_all over 'z' (split y, concat z) -> fft(z, local).
    Fourier layout: (Nz, Ny, Fxp) complex, sharded P(None, 'z', 'y').

The x-frequency axis is zero-padded from ``Nx//2+1`` to the next multiple of
``py`` so the all_to_all split is even; padded columns stay exactly zero
through every (linear) stage and are sliced off on the way back.

Normalization follows the FFTW/numpy convention the reference relies on
(fft_mpi_2d.py:31-45): forward unnormalized, inverse normalized.
"""

from __future__ import annotations

import functools
import warnings

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map


def _cpad(n: int, mult: int) -> int:
    """Round n up to a multiple of mult."""
    return ((n + mult - 1) // mult) * mult


def padded_rfft_size(nx: int, mesh: Mesh | None, grid_dim: int) -> int:
    """Global size of the (padded) x-frequency axis for a given mesh.

    When the z mesh axis is nontrivial, 3D pads to a multiple of
    ``py * DEFAULT_OVERLAP_CHUNKS`` (not just ``py``): the x-freq axis is
    the bystander axis of the z-transpose pipeline segment, and
    ``nx//2 + 1`` is odd for the power-of-two production grids - without
    the extra factor a slab mesh (py = 1) could never chunk its
    all_to_all/conv segment for comm/compute overlap. At pz = 1 that
    segment has no collective to overlap, so the extra width is skipped.
    Padded columns are exactly zero through every linear stage (<= ~2%
    extra width at production sizes)."""
    nxf = nx // 2 + 1
    if mesh is None or mesh.size == 1:
        return nxf
    py = mesh.shape["y"]
    if grid_dim == 2:
        # pencil 2D splits the x-freq axis over BOTH mesh axes
        return _cpad(nxf, py * mesh.shape["x"])
    chunkable = DEFAULT_OVERLAP_CHUNKS if mesh.shape["z"] > 1 else 1
    return _cpad(nxf, py * chunkable)


def fourier_partition_spec(grid_dim: int, mesh: Mesh | None = None) -> P:
    """PartitionSpec of the Fourier-domain layout.

    In slab 2D the (trivial, size-1) 'x' mesh axis is placed on the
    untouched Ny axis so every mesh axis is consumed by the shard_map
    output spec; in pencil 2D (px > 1) the x-freq axis carries both mesh
    axes, x-major (the transpose order of the forward pipeline)."""
    if grid_dim == 2:
        if mesh is not None and mesh.shape["x"] > 1:
            return P(None, ("x", "y"))
        return P("x", "y")
    elif grid_dim == 3:
        return P(None, "z", "y")
    raise ValueError(f"Invalid grid dim {grid_dim}")


# ---------------------------------------------------------------------------
# 2D
# ---------------------------------------------------------------------------


def _rfft2_local(field, *, py: int, px: int, fxp: int):
    if px > 1:
        # gather the full x axis on each device (y splits further)
        field = lax.all_to_all(
            field, "x", split_axis=0, concat_axis=1, tiled=True
        )
    fhat = jnp.fft.rfft(field, axis=1)
    fhat = jnp.pad(fhat, ((0, 0), (0, fxp - fhat.shape[1])))
    if px > 1:
        fhat = lax.all_to_all(fhat, "x", split_axis=1, concat_axis=0, tiled=True)
    if py > 1:
        fhat = lax.all_to_all(fhat, "y", split_axis=1, concat_axis=0, tiled=True)
    return jnp.fft.fft(fhat, axis=0)


def _irfft2_local(fourier, *, py: int, px: int, nx: int):
    fhat = jnp.fft.ifft(fourier, axis=0)
    if py > 1:
        fhat = lax.all_to_all(fhat, "y", split_axis=0, concat_axis=1, tiled=True)
    if px > 1:
        fhat = lax.all_to_all(fhat, "x", split_axis=0, concat_axis=1, tiled=True)
    fhat = fhat[:, : nx // 2 + 1]
    out = jnp.fft.irfft(fhat, n=nx, axis=1)
    if px > 1:
        out = lax.all_to_all(out, "x", split_axis=1, concat_axis=0, tiled=True)
    return out


# ---------------------------------------------------------------------------
# 3D
# ---------------------------------------------------------------------------


def _rfft3_local(field, *, pz: int, py: int, fxp: int):
    fhat = jnp.fft.rfft(field, axis=2)
    fhat = jnp.pad(fhat, ((0, 0), (0, 0), (0, fxp - fhat.shape[2])))
    if py > 1:
        fhat = lax.all_to_all(fhat, "y", split_axis=2, concat_axis=1, tiled=True)
    fhat = jnp.fft.fft(fhat, axis=1)
    if pz > 1:
        fhat = lax.all_to_all(fhat, "z", split_axis=1, concat_axis=0, tiled=True)
    return jnp.fft.fft(fhat, axis=0)


def _irfft3_local(fourier, *, pz: int, py: int, nx: int):
    fhat = jnp.fft.ifft(fourier, axis=0)
    if pz > 1:
        fhat = lax.all_to_all(fhat, "z", split_axis=0, concat_axis=1, tiled=True)
    fhat = jnp.fft.ifft(fhat, axis=1)
    if py > 1:
        fhat = lax.all_to_all(fhat, "y", split_axis=1, concat_axis=2, tiled=True)
    fhat = fhat[:, :, : nx // 2 + 1]
    return jnp.fft.irfft(fhat, n=nx, axis=2)


# ---------------------------------------------------------------------------
# Doubled-domain free-space convolution (lazy padding + early truncation)
# ---------------------------------------------------------------------------
#
# The free-space Poisson solve transforms a zero-padded (2N)^dim domain and
# keeps only the first N cells of the inverse. Padding lazily per axis
# (``fft_padded``) and truncating as early as possible (``ifft_truncated``)
# means the all_to_all transposes move the UNPADDED volume - 4x (3D pencil)
# / 2x (2D slab) less traffic than transforming the monolithically padded
# cube, mirroring the single-device path in ops/poisson.py. The reference's
# counterpart is the doubling communicator + PFFT
# (UnboundedPoissonSolverMPI3D.py:190-382).


def fft_padded(x, axis: int, m: int):
    """FFT of length ``m`` along ``axis`` of ``x`` zero-padded to ``m``."""
    return jnp.fft.fft(x, n=m, axis=axis)


def ifft_truncated(f, axis: int, out_len: int):
    """First ``out_len`` entries of ``jnp.fft.ifft(f, axis=axis)``."""
    return lax.slice_in_dim(jnp.fft.ifft(f, axis=axis), 0, out_len, axis=axis)


def _convolve2_local(field, greens, *, py: int, px: int, ny: int, nx: int,
                     fxp: int):
    if px > 1:
        field = lax.all_to_all(
            field, "x", split_axis=0, concat_axis=1, tiled=True
        )
    f = jnp.fft.rfft(field, n=2 * nx, axis=1)  # (ny/(py*px), nx+1)
    f = jnp.pad(f, ((0, 0), (0, fxp - f.shape[1])))
    if px > 1:
        f = lax.all_to_all(f, "x", split_axis=1, concat_axis=0, tiled=True)
    if py > 1:
        f = lax.all_to_all(f, "y", split_axis=1, concat_axis=0, tiled=True)
    f = fft_padded(f, 0, 2 * ny)  # (2ny, fxp/(py*px))
    f = f * greens
    f = ifft_truncated(f, 0, ny)  # (ny, fxp/(py*px))
    if py > 1:
        f = lax.all_to_all(f, "y", split_axis=0, concat_axis=1, tiled=True)
    if px > 1:
        f = lax.all_to_all(f, "x", split_axis=0, concat_axis=1, tiled=True)
    f = f[:, : nx + 1]
    out = jnp.fft.irfft(f, n=2 * nx, axis=1)
    out = jax.lax.slice_in_dim(out, 0, nx, axis=1)
    if px > 1:
        out = lax.all_to_all(out, "x", split_axis=1, concat_axis=0, tiled=True)
    return out


def _a2a_c(f, name: str, split_axis: int, concat_axis: int,
           compact: bool = False):
    """``lax.all_to_all`` of a complex spectrum, optionally on a bf16
    WIRE format: re/im round to bf16 and BIT-PACK into one uint32 per
    complex element - HALF the transpose bytes of complex64 (opt-in via
    the solvers' ``comm_bf16``). The packing is explicit integer bit
    math, so no backend pass can widen the wire dtype back (a plain
    ``.astype(bf16)`` pair gets hoisted across the collective by XLA's
    convert-fusion and ships f32 anyway - observed on the CPU SPMD
    pipeline). The local math stays float32; only the wire payload rounds
    (solve rel err ~1e-3 class, OFF by default)."""
    if not compact:
        return lax.all_to_all(
            f, name, split_axis=split_axis, concat_axis=concat_axis,
            tiled=True,
        )
    return _a2a_c_packed(f, name, split_axis, concat_axis)


def _a2a_c_packed_impl(f, name: str, split_axis: int, concat_axis: int):
    hi = lax.bitcast_convert_type(
        jnp.real(f).astype(jnp.bfloat16), jnp.uint16
    ).astype(jnp.uint32)
    lo = lax.bitcast_convert_type(
        jnp.imag(f).astype(jnp.bfloat16), jnp.uint16
    ).astype(jnp.uint32)
    w = lax.all_to_all(
        (hi << 16) | lo, name, split_axis=split_axis,
        concat_axis=concat_axis, tiled=True,
    )
    re = lax.bitcast_convert_type(
        (w >> 16).astype(jnp.uint16), jnp.bfloat16
    ).astype(jnp.float32)
    im = lax.bitcast_convert_type(
        (w & 0xFFFF).astype(jnp.uint16), jnp.bfloat16
    ).astype(jnp.float32)
    return jax.lax.complex(re, im)


@functools.partial(jax.custom_vjp, nondiff_argnums=(1, 2, 3))
def _a2a_c_packed(f, name: str, split_axis: int, concat_axis: int):
    return _a2a_c_packed_impl(f, name, split_axis, concat_axis)


def _a2a_c_packed_fwd(f, name, split_axis, concat_axis):
    return _a2a_c_packed_impl(f, name, split_axis, concat_axis), None


def _a2a_c_packed_bwd(name, split_axis, concat_axis, _, ct):
    # the transpose of the (tiled) all_to_all swaps split/concat; the
    # bf16 rounding is treated straight-through (its cotangent rides the
    # same wire format - the knob is a lossy wire, not exact arithmetic)
    return (_a2a_c_packed_impl(ct, name, concat_axis, split_axis),)


_a2a_c_packed.defvjp(_a2a_c_packed_fwd, _a2a_c_packed_bwd)


def _pipeline_chunks(axis_size: int, requested: int) -> int:
    """Largest divisor of ``axis_size`` that is <= ``requested`` (>= 1)."""
    g = max(1, min(requested, axis_size))
    while axis_size % g:
        g -= 1
    return g


def _chunked(f, axis: int, g: int, stage, aux=()):
    """Software-pipeline ``stage`` (a comm -> local-pass chain) over ``g``
    equal chunks of ``f`` along a bystander ``axis``: the chunks are
    independent dataflow chains, so XLA's latency-hiding scheduler can
    overlap chunk i's collective with chunk j's local compute - the manual
    analogue of overlapping the reference's MPI transposes with FFTW work
    (its blocking Alltoallv cannot). ``aux`` operands are split along the
    same axis and passed as extra ``stage`` arguments. No-op at g = 1."""
    if g <= 1:
        return stage(f, *aux)
    parts = zip(
        jnp.split(f, g, axis=axis),
        *(jnp.split(a, g, axis=axis) for a in aux),
    )
    return jnp.concatenate([stage(*p) for p in parts], axis=axis)


def realized_overlap_chunks(nz: int, fxp: int, pz: int, py: int,
                            chunks: int):
    """The chunk counts the three ``_convolve3_local`` segments actually
    realize for a ``chunks`` request (largest divisor of each segment's
    bystander-axis extent <= the request). Mirrors the logic in
    ``_convolve3_local`` so callers / benchmark protocols can detect
    silent degradation (a degraded request lowers the same HLO as a
    smaller one)."""
    g1 = _pipeline_chunks(nz // pz, chunks) if py > 1 else 1
    g2 = _pipeline_chunks(fxp // py, chunks) if pz > 1 else 1
    return g1, g2, g1


def _convolve3_local(field, greens, *, pz: int, py: int, nz: int, ny: int,
                     nx: int, fxp: int, chunks: int = 1,
                     comm_bf16: bool = False):
    """Per-shard 3D doubled-domain convolution over a leading component
    axis (c, nz/pz, ny/py, nx): the components FOLD into each segment's
    batch rows, so every all_to_all moves all c components in ONE
    collective launch (3x fewer launches than per-component solves, same
    total bytes, deeper overlap windows for the latency-hiding scheduler).

    Three pipelined segments, each chunked along an axis the segment's
    all_to_all does not touch so every chunk is a valid independent
    transpose + local pass. Segments are separated by real dataflow
    barriers (the chunk axis changes), so overlap is intra-segment."""
    c = field.shape[0]
    nzl = field.shape[1]  # nz / pz
    g1, g2, g3 = realized_overlap_chunks(nz, fxp, pz, py, chunks)

    def fwd_stage(ch):
        ch = jnp.fft.rfft(ch, n=2 * nx, axis=2)  # (.., ny/py, nx+1)
        ch = jnp.pad(ch, ((0, 0), (0, 0), (0, fxp - ch.shape[2])))
        if py > 1:
            ch = _a2a_c(ch, "y", 2, 1, comm_bf16)
        return fft_padded(ch, 1, 2 * ny)  # (.., 2ny, fxp/py)

    # chunk along the folded (c * nzl) row axis in multiples of c rows so
    # chunk counts (and so the all-to-all count per segment) match the
    # per-component pipeline's realized g1/g3
    f = _chunked(field.reshape(c * nzl, ny // py, nx), 0, g1, fwd_stage)
    bxl = f.shape[2]  # fxp / py

    def conv_stage(ch, g_c):
        if pz > 1:
            ch = _a2a_c(ch, "z", 2, 1, comm_bf16)
        # z-forward * greens -> z-inverse on the shard
        ch = ifft_truncated(
            fft_padded(ch, 1, 2 * nz) * g_c[None], 1, nz
        )  # (c, nz, 2ny/pz, ..)
        if pz > 1:
            ch = _a2a_c(ch, "z", 1, 2, comm_bf16)
        return ch

    # chunk axis -1 = bxl for BOTH the 4D field view and the 3D greens aux
    f = _chunked(
        f.reshape(c, nzl, 2 * ny, bxl), -1, g2, conv_stage, aux=(greens,)
    )

    def inv_stage(ch):
        ch = ifft_truncated(ch, 1, ny)  # (.., ny, fxp/py)
        if py > 1:
            ch = _a2a_c(ch, "y", 1, 2, comm_bf16)
        ch = ch[:, :, : nx + 1]
        out = jnp.fft.irfft(ch, n=2 * nx, axis=2)
        return jax.lax.slice_in_dim(out, 0, nx, axis=2)

    out = _chunked(f.reshape(c * nzl, 2 * ny, bxl), 0, g3, inv_stage)
    return out.reshape(c, nzl, ny // py, nx)


#: default requested chunk count for the comm/compute software pipeline of
#: the 3D distributed convolve (see ``_chunked``); 1 disables pipelining.
#: The default is not yet measured against 1 on GPUs (ROADMAP R2).
DEFAULT_OVERLAP_CHUNKS = 4


def distributed_free_space_convolve(rhs, greens, mesh: Mesh,
                                    overlap_chunks: int | None = None,
                                    comm_bf16: bool = False):
    """Spectral free-space convolution of a sharded N-domain ``rhs`` with a
    real doubled-domain Fourier multiplier ``greens`` (layout
    ``fourier_partition_spec``, i.e. the output of ``distributed_rfftn`` on
    the even-reflected doubled kernel). Returns the N-domain solution with
    the input's sharding. The doubled field never materializes. A 3D
    ``rhs`` may carry a leading component axis, which folds into every
    transpose payload.

    ``overlap_chunks`` software-pipelines each all_to_all transpose with
    the adjacent local pass by splitting the 3D pipeline into independent
    chunks along a bystander axis (None = the ``DEFAULT_OVERLAP_CHUNKS``
    policy; 1 disables). It is a REQUEST: each segment realizes the
    largest divisor of its bystander-axis extent <= the request (the
    x-freq axis is only padded to guarantee divisibility by
    ``DEFAULT_OVERLAP_CHUNKS`` when pz > 1) - benchmark protocols
    comparing chunk depths should check the lowered all-to-all count, not
    assume the request. Chunking is exact (the chunks partition the batch
    rows of each linear pass) and is a no-op on mesh axes of size 1, so
    single-device behavior is untouched. The 2D path is transpose-light
    (slab grids a few hundred KB per shard) and is not chunked."""
    batched = rhs.ndim == 4
    grid_dim = 3 if batched else rhs.ndim
    fxp = padded_rfft_size(2 * rhs.shape[-1], mesh, grid_dim)
    if grid_dim == 2:
        ny, nx = rhs.shape
        fn = functools.partial(
            _convolve2_local, py=mesh.shape["y"], px=mesh.shape["x"],
            ny=ny, nx=nx, fxp=fxp,
        )
    else:
        nz, ny, nx = rhs.shape[-3:]
        pz, py = mesh.shape["z"], mesh.shape["y"]
        if overlap_chunks is not None and overlap_chunks < 1:
            raise ValueError(
                f"overlap_chunks must be >= 1 (got {overlap_chunks}); "
                "pass 1 to disable the comm/compute pipeline"
            )
        chunks = (
            DEFAULT_OVERLAP_CHUNKS if overlap_chunks is None
            else overlap_chunks
        )
        if overlap_chunks is not None and chunks > 1:
            # an explicit request that silently degrades lowers the same
            # HLO as a smaller one - warn so A/B protocols don't compare
            # identical programs
            realized = realized_overlap_chunks(nz, fxp, pz, py, chunks)
            if any(g != chunks for g in realized):
                warnings.warn(
                    f"overlap_chunks={chunks} realized as "
                    f"(fwd, conv, inv)={realized} on mesh (pz={pz}, "
                    f"py={py}) at grid ({nz}, {ny}, {nx}); segments "
                    "realize the largest divisor of their bystander-axis "
                    "extent <= the request",
                    stacklevel=2,
                )
        local = functools.partial(
            _convolve3_local, pz=pz, py=py,
            nz=nz, ny=ny, nx=nx, fxp=fxp,
            chunks=chunks, comm_bf16=comm_bf16,
        )
        fn = local if batched else (lambda r, g: local(r[None], g)[0])
    spec = _grid_spec(grid_dim)
    if batched:
        spec = P(None, *spec)
    return shard_map(
        fn,
        mesh=mesh,
        in_specs=(spec, fourier_partition_spec(grid_dim, mesh)),
        out_specs=spec,
        # the bf16 wire format's custom VJP cannot carry varying-mesh-axes
        # metadata on its cotangents; the specs above pin the layouts
        check_vma=False,
    )(rhs, greens)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def distributed_rfftn(field, mesh: Mesh | None):
    """Forward real FFT of a sharded grid field (unnormalized).

    Single-device (or meshless) path uses plain XLA ``rfftn``; multi-device
    path runs the pencil pipeline described in the module docstring.
    """
    grid_dim = field.ndim
    if mesh is None or mesh.size == 1:
        # rfftn with x treated as the innermost transform to match layouts
        out = jnp.fft.rfft(field, axis=grid_dim - 1)
        for ax in range(grid_dim - 2, -1, -1):
            out = jnp.fft.fft(out, axis=ax)
        return out

    spec = _grid_spec(grid_dim)
    fxp = padded_rfft_size(field.shape[-1], mesh, grid_dim)
    if grid_dim == 2:
        fn = functools.partial(
            _rfft2_local, py=mesh.shape["y"], px=mesh.shape["x"], fxp=fxp
        )
    else:
        fn = functools.partial(
            _rfft3_local, pz=mesh.shape["z"], py=mesh.shape["y"], fxp=fxp
        )
    return shard_map(
        fn, mesh=mesh, in_specs=spec,
        out_specs=fourier_partition_spec(grid_dim, mesh),
    )(field)


def distributed_irfftn(fourier, nx: int, mesh: Mesh | None):
    """Inverse of :func:`distributed_rfftn` (normalized). ``nx`` is the
    global size of the last (real) axis."""
    grid_dim = fourier.ndim
    if mesh is None or mesh.size == 1:
        out = fourier
        for ax in range(grid_dim - 2, -1, -1):
            out = jnp.fft.ifft(out, axis=ax)
        return jnp.fft.irfft(out[..., : nx // 2 + 1], n=nx, axis=grid_dim - 1)

    if grid_dim == 2:
        fn = functools.partial(
            _irfft2_local, py=mesh.shape["y"], px=mesh.shape["x"], nx=nx
        )
    else:
        fn = functools.partial(
            _irfft3_local, pz=mesh.shape["z"], py=mesh.shape["y"], nx=nx
        )
    return shard_map(
        fn,
        mesh=mesh,
        in_specs=fourier_partition_spec(grid_dim, mesh),
        out_specs=_grid_spec(grid_dim),
    )(fourier)


def _grid_spec(grid_dim: int) -> P:
    if grid_dim == 2:
        return P("y", "x")
    return P("z", "y", None)
