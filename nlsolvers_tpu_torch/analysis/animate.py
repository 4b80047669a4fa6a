"""Trajectory animation and snapshot montages.

Ports of the reference viz scripts (scripts/animate_hdf.py:19-83 2D imshow
FuncAnimation; the reference's animate_3d.py marching-cubes isosurfaces).
skimage is not in this environment, so the isosurface path uses the
dependency-free marching-tetrahedra extractor (analysis/isosurface.py);
`animate_3d_slices` additionally renders orthogonal mid-plane slices as the
cheaper quick-look.

matplotlib is imported lazily with the Agg backend so headless batch use
(and importing this module on a worker) never needs a display.

The port's copy of nlsolvers_tpu/analysis/animate.py (numpy and
matplotlib, as there).
"""

import numpy as np

__all__ = ["animate_2d", "animate_3d_slices", "animate_3d_isosurface",
           "snapshot_grid"]


def _plt():
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    return plt


def _frame_data(traj):
    return np.abs(traj) if np.iscomplexobj(traj) else np.asarray(traj)


def animate_2d(traj, out_path, extent=None, cmap="viridis", fps=10,
               title=""):
    """Write an animation of a (S, ny, nx) snapshot stack (|u| if complex).

    Saves .gif (pillow writer) or .mp4 if ffmpeg is available; parity with
    animate_hdf.py's imshow FuncAnimation."""
    plt = _plt()
    from matplotlib import animation

    data = _frame_data(traj)
    vmin, vmax = np.nanmin(data), np.nanmax(data)
    fig, ax = plt.subplots(figsize=(6, 6))
    im = ax.imshow(data[0], origin="lower", cmap=cmap, vmin=vmin, vmax=vmax,
                   extent=extent)
    fig.colorbar(im, ax=ax, shrink=0.8)
    txt = ax.set_title(f"{title} t=0/{len(data) - 1}")

    def update(i):
        im.set_data(data[i])
        txt.set_text(f"{title} t={i}/{len(data) - 1}")
        return [im]

    ani = animation.FuncAnimation(fig, update, frames=len(data),
                                  blit=False)
    writer = ("ffmpeg" if str(out_path).endswith(".mp4") else "pillow")
    ani.save(out_path, writer=writer, fps=fps)
    plt.close(fig)
    return out_path


def animate_3d_slices(traj, out_path, cmap="viridis", fps=10, title=""):
    """Animate a (S, nz, ny, nx) stack as three orthogonal mid-plane slices
    (the environment-compatible stand-in for animate_3d.py isosurfaces)."""
    plt = _plt()
    from matplotlib import animation

    data = _frame_data(traj)
    S, nz, ny, nx = data.shape
    vmin, vmax = np.nanmin(data), np.nanmax(data)
    fig, axes = plt.subplots(1, 3, figsize=(14, 5))
    planes = [lambda f: f[nz // 2], lambda f: f[:, ny // 2],
              lambda f: f[:, :, nx // 2]]
    names = ["z mid-plane", "y mid-plane", "x mid-plane"]
    ims = []
    for ax, plane, name in zip(axes, planes, names):
        im = ax.imshow(plane(data[0]), origin="lower", cmap=cmap,
                       vmin=vmin, vmax=vmax)
        ax.set_title(name)
        ims.append(im)
    sup = fig.suptitle(f"{title} t=0/{S - 1}")

    def update(i):
        for im, plane in zip(ims, planes):
            im.set_data(plane(data[i]))
        sup.set_text(f"{title} t={i}/{S - 1}")
        return ims

    ani = animation.FuncAnimation(fig, update, frames=S, blit=False)
    writer = ("ffmpeg" if str(out_path).endswith(".mp4") else "pillow")
    ani.save(out_path, writer=writer, fps=fps)
    plt.close(fig)
    return out_path


def animate_3d_isosurface(traj, out_path, level=None, spacing=None,
                          origin=None, fps=10, title="", color="#3b7bbf",
                          elev=20.0, azim=-60.0):
    """Animate a (S, nz, ny, nx) stack as a rotating isosurface mesh.

    Parity target: the reference's animate_3d.py (skimage marching cubes +
    Poly3DCollection); here the mesh comes from the dependency-free
    marching-tetrahedra extractor (analysis/isosurface.py). `level`
    defaults to the reference script's 0.3 * max|u| threshold
    (animate_3d.py:26); complex input is rendered as |u|.
    """
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    from nlsolvers_tpu_torch.analysis.isosurface import marching_tetrahedra

    plt = _plt()
    from matplotlib import animation

    data = _frame_data(traj)
    S, nz, ny, nx = data.shape
    if level is None:
        level = 0.3 * float(np.nanmax(data))
    spacing = spacing or (1.0, 1.0, 1.0)
    origin = origin or (0.0, 0.0, 0.0)
    lims = [(origin[d], origin[d] + spacing[d] * (data.shape[1 + d] - 1))
            for d in range(3)]

    fig = plt.figure(figsize=(7, 6))
    ax = fig.add_subplot(projection="3d")
    ax.view_init(elev=elev, azim=azim)

    def draw(i):
        ax.clear()
        verts, tris = marching_tetrahedra(data[i], level, spacing, origin)
        if len(tris):
            # verts are [z, y, x]; plot as (x, y, z)
            mesh = Poly3DCollection(verts[tris][:, :, ::-1], alpha=0.6,
                                    facecolor=color, edgecolor="none")
            ax.add_collection3d(mesh)
        ax.set_xlim(lims[2])
        ax.set_ylim(lims[1])
        ax.set_zlim(lims[0])
        ax.set_title(f"{title} |u|={level:.3g} t={i}/{S - 1}")
        return []

    ani = animation.FuncAnimation(fig, draw, frames=S, blit=False)
    writer = ("ffmpeg" if str(out_path).endswith(".mp4") else "pillow")
    ani.save(out_path, writer=writer, fps=fps)
    plt.close(fig)
    return out_path


def snapshot_grid(traj, out_path, n_frames=9, cmap="viridis", title=""):
    """Static montage of evenly spaced snapshots — the quick-look figure the
    launchers drop next to each study (compare_utils plot helpers)."""
    plt = _plt()
    data = _frame_data(traj)
    S = data.shape[0]
    idx = np.linspace(0, S - 1, min(n_frames, S)).astype(int)
    cols = int(np.ceil(np.sqrt(len(idx))))
    rows = int(np.ceil(len(idx) / cols))
    fig, axes = plt.subplots(rows, cols, figsize=(3 * cols, 3 * rows),
                             squeeze=False)
    vmin, vmax = np.nanmin(data), np.nanmax(data)
    for k, ax in enumerate(axes.ravel()):
        ax.axis("off")
        if k < len(idx):
            frame = data[idx[k]]
            if frame.ndim == 3:          # 3D: z mid-plane
                frame = frame[frame.shape[0] // 2]
            ax.imshow(frame, origin="lower", cmap=cmap, vmin=vmin,
                      vmax=vmax)
            ax.set_title(f"t={idx[k]}", fontsize=9)
    fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path
