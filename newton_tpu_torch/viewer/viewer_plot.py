"""Matplotlib offline viewer (port of ``newton_tpu/viewer/viewer_plot.py``):
body frames and particles as a 3D scatter, and logged images, written as
PNG sequences. matplotlib is imported when the viewer is made (under the
Agg backend), never when this module is."""

from __future__ import annotations

import os

from .viewer import ViewerBase, to_numpy

__all__ = ["ViewerPlot"]


class ViewerPlot(ViewerBase):
    def __init__(self, out_dir: str = "frames", every: int = 1,
                 elev: float = 20.0, azim: float = -60.0,
                 bounds: float = 2.0):
        super().__init__()
        try:
            import matplotlib
            matplotlib.use("Agg")
        except ImportError as e:
            raise ImportError("ViewerPlot requires matplotlib") from e
        self.out_dir = out_dir
        self.every = int(every)
        self.elev, self.azim = elev, azim
        self.bounds = bounds
        os.makedirs(out_dir, exist_ok=True)

    def log_state(self, state):
        if self._frame % self.every:
            return
        import matplotlib.pyplot as plt
        fig = plt.figure(figsize=(5, 5))
        ax = fig.add_subplot(projection="3d")
        bq = to_numpy(state.body_q).reshape(-1, 7)
        if len(bq):
            ax.scatter(bq[:, 0], bq[:, 1], bq[:, 2], c="tab:blue", s=40)
        if state.particle_q.shape[-2]:
            pq = to_numpy(state.particle_q).reshape(-1, 3)
            ax.scatter(pq[:, 0], pq[:, 1], pq[:, 2], c="tab:orange", s=4)
        b = self.bounds
        ax.set_xlim(-b, b)
        ax.set_ylim(-b, b)
        ax.set_zlim(0, 2 * b)
        ax.view_init(self.elev, self.azim)
        ax.set_title(f"t = {self.time:.3f}s")
        fig.savefig(os.path.join(self.out_dir, f"frame_{self._frame:05d}.png"),
                    dpi=80)
        plt.close(fig)

    def log_image(self, name, image):
        import matplotlib.pyplot as plt
        img = to_numpy(image)
        fig, ax = plt.subplots(figsize=(4, 4))
        ax.imshow(img, cmap=None if img.ndim == 3 else "viridis")
        ax.axis("off")
        fig.savefig(os.path.join(self.out_dir, f"{name.replace('/', '_')}_"
                                 f"{self._frame:05d}.png"), dpi=80)
        plt.close(fig)
