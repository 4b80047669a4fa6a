"""Trajectory downsampling: spectral crop and grid interpolation, 2D + 3D.

Capability parity with finalized_scripts/downsampling.py:10-301, redesigned
dimension-generically (one implementation per method instead of per-dim
copies) in numpy/scipy — no torch. The interpolation path is preferred for
the no-flux (non-periodic) trajectories (complex_launcher_2d.py:337-340);
FFT crop is exact for band-limited periodic data.

All functions take (nt, *spatial) stacks and treat the leading axis as time.
"""

import numpy as np
from scipy.interpolate import RegularGridInterpolator

__all__ = ["downsample_fft", "reconstruct_fft", "downsample_interpolation",
           "reconstruct_interpolation", "downsample_trajectory"]


def _spatial_axes(ndim_spatial):
    return tuple(range(-ndim_spatial, 0))


def downsample_fft(u, target_shape):
    """Centered Fourier crop with 'ortho' norm (downsampling.py:10-33)."""
    target_shape = tuple(target_shape)
    d = len(target_shape)
    axes = _spatial_axes(d)
    orig = u.shape[-d:]
    ft = np.fft.fftshift(np.fft.fftn(u, axes=axes, norm="ortho"), axes=axes)
    sl = [slice(None)] * (u.ndim - d)
    for o, t in zip(orig, target_shape):
        s = (o - t) // 2
        sl.append(slice(s, s + t))
    ft = np.fft.ifftshift(ft[tuple(sl)], axes=axes)
    out = np.fft.ifftn(ft, axes=axes, norm="ortho")
    if not np.iscomplexobj(u):
        out = out.real
    return out.astype(u.dtype)


def reconstruct_fft(downsampled, original_shape):
    """Zero-padded inverse of downsample_fft (downsampling.py:36-65)."""
    original_shape = tuple(original_shape)
    d = len(original_shape)
    axes = _spatial_axes(d)
    cur = downsampled.shape[-d:]
    ft = np.fft.fftshift(np.fft.fftn(downsampled, axes=axes, norm="ortho"),
                         axes=axes)
    padded = np.zeros(downsampled.shape[:-d] + original_shape,
                      dtype=complex)
    sl = [slice(None)] * (downsampled.ndim - d)
    for o, c in zip(original_shape, cur):
        s = (o - c) // 2
        sl.append(slice(s, s + c))
    padded[tuple(sl)] = ft
    padded = np.fft.ifftshift(padded, axes=axes)
    out = np.fft.ifftn(padded, axes=axes, norm="ortho")
    if not np.iscomplexobj(downsampled):
        out = out.real
    return out.astype(downsampled.dtype)


def _interp_stack(u, src_axes, dst_axes):
    dst_mesh = np.meshgrid(*dst_axes, indexing="ij")
    pts = np.stack([m.ravel() for m in dst_mesh], axis=-1)
    out_shape = tuple(len(a) for a in dst_axes)
    out = np.empty(u.shape[:1] + out_shape, dtype=u.dtype)
    for t in range(u.shape[0]):
        f = RegularGridInterpolator(src_axes, u[t], method="linear",
                                    bounds_error=False, fill_value=None)
        out[t] = f(pts).reshape(out_shape)
    return out


def downsample_interpolation(u, target_shape, *extents, original_grid=None):
    """Linear resampling onto a coarser [-L, L] grid
    (downsampling.py:68-103, 215-257). `extents` are Lx[, Ly[, Lz]]; a
    single extent is broadcast."""
    target_shape = tuple(target_shape)
    d = len(target_shape)
    if len(extents) == 1:
        extents = extents * d
    src = original_grid if original_grid is not None else tuple(
        np.linspace(-L, L, n) for L, n in zip(extents, u.shape[-d:]))
    dst = tuple(np.linspace(-L, L, n)
                for L, n in zip(extents, target_shape))
    return _interp_stack(u, src, dst)


def reconstruct_interpolation(downsampled, original_shape, *extents,
                              downsampled_grid=None):
    """Inverse of downsample_interpolation (downsampling.py:106-144)."""
    original_shape = tuple(original_shape)
    d = len(original_shape)
    if len(extents) == 1:
        extents = extents * d
    src = downsampled_grid if downsampled_grid is not None else tuple(
        np.linspace(-L, L, n)
        for L, n in zip(extents, downsampled.shape[-d:]))
    dst = tuple(np.linspace(-L, L, n)
                for L, n in zip(extents, original_shape))
    return _interp_stack(downsampled, src, dst)


def downsample_trajectory(u, target_shape, *extents, method="interpolation"):
    """Launcher-facing dispatcher (complex_launcher_2d.py:176-189)."""
    if tuple(target_shape) == u.shape[1:]:
        return u
    if method == "fft":
        return downsample_fft(u, target_shape)
    if np.iscomplexobj(u):
        re = downsample_interpolation(u.real, target_shape, *extents)
        im = downsample_interpolation(u.imag, target_shape, *extents)
        return (re + 1j * im).astype(u.dtype)
    return downsample_interpolation(u, target_shape, *extents)
