"""Unbounded (free-space) Poisson solvers via Green's-function convolution.

JAX counterpart of the reference's
``UnboundedPoissonSolverMPI2D/3D`` (/root/reference/sopht_mpi/numeric/
eulerian_grid_ops/poisson_solver_2d/UnboundedPoissonSolverMPI2D.py,
poisson_solver_3d/UnboundedPoissonSolverMPI3D.py): Hockney-Eastwood domain
doubling + FFT convolution with the even-reflected free-space Green's
function. Solves ``-del^2(solution) = rhs`` on an unbounded domain.

Differences from the reference (deliberate):
- The bespoke ``MPIDomainDoublingCommunicator`` redistribution (2D :156-352,
  3D :190-382) disappears: doubling is ``jnp.pad`` on a sharded array and
  the truncation is a slice - XLA emits whatever data movement is needed.
- Distributed FFTs are the pencil ``all_to_all`` pipeline in
  parallel/fft.py instead of FFTW+MPI.
- The Fourier Green's function of the even-reflected kernel is real
  (even symmetry), so we store only its real part: the spectral multiply is
  complex*real - half the memory traffic of the reference's complex product
  (UnboundedPoissonSolverMPI2D.py:56-58).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from sopht_mpi_tpu.parallel.fft import (
    distributed_free_space_convolve,
    distributed_rfftn,
    fft_padded,
    ifft_truncated,
)


# -- single-device free-space convolution transforms -------------------------
#
# The doubled-domain FFT operates on a zero-padded input and only the first
# N cells of the inverse are kept. Padding each axis lazily (the ``n=``
# argument of the forward pass) and truncating each axis as early as
# possible means the first forward pass touches 1/4 of the doubled volume
# and the second 1/2 (and mirrored on the inverse): ~40% less memory
# traffic than transforming the monolithically padded cube.


def _padded_rfftn_local(field, doubled: tuple[int, ...]):
    nd = field.ndim
    out = jnp.fft.rfft(field, n=doubled[-1], axis=nd - 1)
    for ax in range(nd - 2, -1, -1):
        out = fft_padded(out, ax, doubled[ax])
    return out


def _truncated_irfftn_local(fourier, out_shape: tuple[int, ...]):
    nd = fourier.ndim
    out = fourier
    for ax in range(nd - 1):
        out = ifft_truncated(out, ax, out_shape[ax])
    out = jnp.fft.irfft(out, n=2 * out_shape[-1], axis=nd - 1)
    return jax.lax.slice_in_dim(out, 0, out_shape[-1], axis=nd - 1)


def _even_reflected_axis_dist(n_doubled: int, dx: float, axis_range: float, dtype):
    """Per-axis distance ``min(x, 2 L - x)`` on the doubled grid."""
    x = np.arange(n_doubled, dtype=np.float64) * dx
    return np.minimum(x, 2.0 * axis_range - x).astype(dtype)


def _device_greens_build(flag: bool | None, doubled_elems: int) -> bool:
    """Auto policy: build the Green's function on device for large grids
    (where the host build and upload dominate set-up time); keep the
    float64 host build for small/test grids."""
    if flag is not None:
        return flag
    return doubled_elems >= 2**24


def _build_greens_kernel(axis_dists, compute_greens, regularized_origin,
                         dtype, *, on_device: bool, sharding=None):
    """Assemble the real-space Green's function from per-axis distance
    vectors. ``compute_greens(xp, r)`` maps distances to kernel values with
    the array module ``xp``.

    - on_device: built under jit from tiny O(N) vectors - only O(N) bytes
      leave the host; with ``sharding`` each device builds only its block.
    - host: float64 numpy build (the reference's precision) for small/test
      grids.
    """
    nd = len(axis_dists)
    if on_device:
        @functools.partial(jax.jit, out_shardings=sharding)
        def build(*dists):
            sq = sum(
                d.reshape((-1,) + (1,) * (nd - 1 - i)) ** 2
                for i, d in enumerate(dists)
            )
            g = compute_greens(jnp, jnp.sqrt(sq))
            return g.at[(0,) * nd].set(regularized_origin).astype(dtype)

        return build(*[jnp.asarray(d, dtype=dtype) for d in axis_dists])
    sq = sum(
        np.asarray(d, np.float64).reshape((-1,) + (1,) * (nd - 1 - i)) ** 2
        for i, d in enumerate(axis_dists)
    )
    with np.errstate(divide="ignore"):
        g = compute_greens(np, np.sqrt(sq))
    g[(0,) * nd] = regularized_origin
    return g.astype(dtype)


class UnboundedPoissonSolver2D:
    """Free-space Poisson solver on a 2D (ny, nx) grid.

    Green's function ``-log(r)/(2 pi)`` with the reference's origin
    regularization ``-(2 log(dx/sqrt(pi)) - 1)/(4 pi)``
    (UnboundedPoissonSolverMPI2D.py:95-101).
    """

    grid_dim = 2

    def __init__(self, grid_size_y, grid_size_x, x_range=1.0,
                 real_t=jnp.float32, mesh=None,
                 build_greens_on_device: bool | None = None):
        self.grid_size_y = grid_size_y
        self.grid_size_x = grid_size_x
        self.x_range = x_range
        self.y_range = x_range * (grid_size_y / grid_size_x)
        self.dx = float(x_range / grid_size_x)
        self.real_t = real_t
        self.mesh = mesh

        dy = _even_reflected_axis_dist(
            2 * grid_size_y, self.dx, self.y_range, np.float64
        )
        dxs = _even_reflected_axis_dist(
            2 * grid_size_x, self.dx, self.x_range, np.float64
        )
        origin = -(2.0 * np.log(self.dx / np.sqrt(np.pi)) - 1.0) / (4.0 * np.pi)
        compute = lambda xp, r: -xp.log(r) / (2.0 * np.pi)
        if mesh is None or mesh.size == 1:
            # single-device: half-grid kernel + symmetric-DFT spectrum
            half = _build_greens_kernel(
                (dy[: grid_size_y + 1], dxs[: grid_size_x + 1]),
                compute, origin, np.dtype(real_t),
                on_device=_device_greens_build(
                    build_greens_on_device, 4 * grid_size_y * grid_size_x
                ),
            )
            self._init_fourier_greens_from_half(half)
        else:
            # mesh path: host float64 build (a device build would round
            # trip through the host in shard_scalar_field anyway)
            greens = _build_greens_kernel(
                (dy, dxs), compute, origin, np.dtype(real_t),
                on_device=False,
            )
            self._init_fourier_greens(greens)

    def _init_fourier_greens(self, greens: np.ndarray):
        """Forward-transform the (real-spectrum) Green's function once,
        scaled by dx^dim (the convolution quadrature weight)."""
        from sopht_mpi_tpu.parallel.mesh import shard_scalar_field

        g = shard_scalar_field(jnp.asarray(greens), self.mesh)
        ghat = distributed_rfftn(g, self.mesh)
        self.fourier_greens_times_dx_pow_dim = (
            jnp.real(ghat) * self.dx**self.grid_dim
        )

    def _init_fourier_greens_from_half(self, greens_half):
        """Fourier Green's function from the HALF-grid kernel via per-axis
        symmetric DFT (DCT-I) matmuls, exploiting the even reflection:
        g[n] = g[2N - n] per axis, so

            Ghat[k] = g[0] + (-1)^k g[N] + 2 sum_{n=1}^{N-1} g[n] cos(pi n k / N)

        with Ghat[k] = Ghat[2N - k] real-even. The doubled-domain kernel
        never materializes and no (2N)^dim FFT runs, so the set-up peak
        stays a fraction of the doubled kernel's size. ``greens_half`` has
        N+1 points per axis (distances never reflect there).
        """
        dtype = greens_half.dtype
        h = jnp.asarray(greens_half)
        nd = h.ndim

        # Per-axis DCT matrices M[n, k] = w_n cos(pi n k / N) built
        # HOST-SIDE in float64 then cast: at N = 512 the angle reaches
        # ~1.6e3 rad, where float32 argument rounding costs ~1e-4 per
        # cosine entry - the O(N^2) matrices are tiny, only the O(N^3)
        # contraction belongs on device. They enter the jitted build as
        # traced arguments, not as compiled-in constants.
        dct_mats = []
        for ax in range(nd):
            n_half = greens_half.shape[ax]  # N + 1
            n = np.arange(n_half, dtype=np.float64)[:, None]
            k = np.arange(n_half, dtype=np.float64)[None, :]
            mat = np.cos(np.pi * n * k / (n_half - 1))
            w = np.full((n_half, 1), 2.0)
            w[0, 0] = 1.0
            w[-1, 0] = 1.0
            dct_mats.append((w * mat).astype(dtype))

        @jax.jit
        def build(h, *mats):
            # per-axis symmetric DFT: contract axis `ax` (size N+1) against
            # M[n, k] = w_n cos(pi n k / N), w = (1, 2, ..., 2, 1); output
            # k in [0, N] (the even-symmetric half)
            for ax in range(nd):
                h = jnp.moveaxis(
                    jnp.tensordot(
                        jnp.moveaxis(h, ax, -1), mats[ax], axes=1,
                        precision=jax.lax.Precision.HIGHEST,
                    ),
                    -1, ax,
                )
            # expand even-symmetric halves to the full doubled spectrum on
            # every axis but the last (kept at fx = N+1 by rfft symmetry)
            for ax in range(nd - 1):
                head = h
                tail = jnp.flip(
                    jax.lax.slice_in_dim(h, 1, h.shape[ax] - 1, axis=ax), ax
                )
                h = jnp.concatenate([head, tail], axis=ax)
            return h * (self.dx**self.grid_dim)

        self.fourier_greens_times_dx_pow_dim = build(h, *dct_mats)

    def _convolve(self, rhs_field, greens, **dist_kwargs):
        """Free-space convolution of ``rhs_field`` (grid shape, optionally
        with a leading component axis on a mesh) with the Fourier Green's
        function."""
        if greens is None:
            greens = self.fourier_greens_times_dx_pow_dim
        if self.mesh is None or self.mesh.size == 1:
            shape = rhs_field.shape
            fhat = _padded_rfftn_local(rhs_field, tuple(2 * n for n in shape))
            return _truncated_irfftn_local(fhat * greens, shape)
        return distributed_free_space_convolve(
            rhs_field, greens, self.mesh, **dist_kwargs
        )

    def solve(self, rhs_field, greens=None):
        """Solve ``-del^2(solution) = rhs`` for an unbounded domain.

        Pure function of ``rhs_field`` (shape (ny, nx)); safe to call under
        jit and grad.

        :param greens: optional explicit Fourier Green's function
            (``self.fourier_greens_times_dx_pow_dim``). Pass it as a traced
            jit argument to keep the large array out of the compiled
            program's constants (it is ~(2N)^dim/2 floats).
        """
        return self._convolve(rhs_field, greens)


class UnboundedPoissonSolver3D:
    """Free-space Poisson solver on a 3D (nz, ny, nx) grid.

    Green's function ``1/(4 pi r)`` with origin regularization
    ``1/(4 pi dx)`` (UnboundedPoissonSolverMPI3D.py:101-118).
    """

    grid_dim = 3

    def __init__(self, grid_size_z, grid_size_y, grid_size_x, x_range=1.0,
                 real_t=jnp.float32, mesh=None,
                 build_greens_on_device: bool | None = None,
                 overlap_chunks: int | None = None,
                 comm_bf16: bool = False):
        self.grid_size_z = grid_size_z
        self.grid_size_y = grid_size_y
        self.grid_size_x = grid_size_x
        # comm/compute pipelining request of the distributed convolve
        # (None = fft.DEFAULT_OVERLAP_CHUNKS; 1 disables). Meshless solvers
        # never chunk.
        self.overlap_chunks = overlap_chunks
        # opt-in bf16 WIRE format for the distributed transposes: halves
        # the all_to_all bytes at a ~2e-3 solve rel-err cost (OFF by
        # default; see fft._a2a_c). Meshless solvers have no transposes -
        # the flag is a no-op there.
        self.comm_bf16 = bool(comm_bf16)
        self.x_range = x_range
        self.y_range = x_range * (grid_size_y / grid_size_x)
        self.z_range = x_range * (grid_size_z / grid_size_x)
        self.dx = float(x_range / grid_size_x)
        self.real_t = real_t
        self.mesh = mesh

        dz = _even_reflected_axis_dist(
            2 * grid_size_z, self.dx, self.z_range, np.float64
        )
        dy = _even_reflected_axis_dist(
            2 * grid_size_y, self.dx, self.y_range, np.float64
        )
        dxs = _even_reflected_axis_dist(
            2 * grid_size_x, self.dx, self.x_range, np.float64
        )
        origin = 1.0 / (4.0 * np.pi * self.dx)
        compute = lambda xp, r: 1.0 / (4.0 * np.pi * r)
        on_device = _device_greens_build(
            build_greens_on_device,
            8 * grid_size_z * grid_size_y * grid_size_x,
        )
        if mesh is None or mesh.size == 1:
            # single-device: half-grid kernel + symmetric-DFT spectrum
            half = _build_greens_kernel(
                (dz[: grid_size_z + 1], dy[: grid_size_y + 1],
                 dxs[: grid_size_x + 1]),
                compute, origin, np.dtype(real_t), on_device=on_device,
            )
            self._init_fourier_greens_from_half(half)
        else:
            # mesh path: the full doubled kernel feeds distributed_rfftn;
            # a device build lands already sharded
            from sopht_mpi_tpu.parallel.mesh import scalar_field_sharding

            greens = _build_greens_kernel(
                (dz, dy, dxs), compute, origin, np.dtype(real_t),
                on_device=on_device, sharding=scalar_field_sharding(mesh),
            )
            UnboundedPoissonSolver2D._init_fourier_greens(self, greens)

    _init_fourier_greens_from_half = (
        UnboundedPoissonSolver2D._init_fourier_greens_from_half
    )
    _convolve = UnboundedPoissonSolver2D._convolve

    def _dist_kwargs(self):
        return dict(
            overlap_chunks=self.overlap_chunks, comm_bf16=self.comm_bf16
        )

    def solve(self, rhs_field, greens=None):
        """Solve ``-del^2(solution) = rhs`` (shape (nz, ny, nx)).

        :param greens: optional explicit Fourier Green's function; see
            :meth:`UnboundedPoissonSolver2D.solve`.
        """
        return self._convolve(rhs_field, greens, **self._dist_kwargs())

    def vector_field_solve(self, rhs_vector_field, greens=None):
        """Component-wise solve for a (3, nz, ny, nx) vector field
        (UnboundedPoissonSolverMPI3D.py:169-187). On one device the
        components are vmapped through one batched pipeline; on a mesh
        they fold into every transpose payload, so the vector solve issues
        3x fewer collective launches than per-component solves."""
        if self.mesh is None or self.mesh.size == 1:
            return jax.vmap(lambda f: self.solve(f, greens))(rhs_vector_field)
        return self._convolve(
            rhs_vector_field, greens, **self._dist_kwargs()
        )
