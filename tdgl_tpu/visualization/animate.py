"""Render saved frames to an animation (gif/mp4).

API parity with the reference ``tdgl/visualization/animate.py:19``.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence, Union

import numpy as np

from ..solution.data import get_data_range
from .common import DEFAULT_QUANTITIES, PLOT_DEFAULTS, Quantity, auto_grid
from .io import get_plot_data, get_state_string

logger = logging.getLogger(__name__)


def create_animation(
    input_file: Union[str, h5py.File],
    *,
    output_file: Optional[str] = None,
    quantities: Union[Sequence[str], str] = DEFAULT_QUANTITIES,
    shading: str = "gouraud",
    fps: int = 30,
    dpi: float = 100,
    max_cols: int = 4,
    min_frame: int = 0,
    max_frame: int = -1,
    autoscale: bool = False,
    dimensionless: bool = False,
    axis_labels: bool = False,
    axes_off: bool = False,
    title_off: bool = False,
    full_title: bool = True,
    figure_kwargs: Optional[dict] = None,
    writer=None,
    silent: bool = False,
):
    """Create a matplotlib FuncAnimation over the saved frames.

    Returns the animation object; saves it to ``output_file`` if given.
    """
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation
    from tqdm import tqdm

    from ..device.device import Device
    from ..fv.mesh import Mesh
    from .common import non_gui_backend

    if isinstance(quantities, str):
        quantities = [quantities]
    quantities = [Quantity.from_key(str(q)) for q in quantities]

    own_file = isinstance(input_file, str)
    import h5py
    f = h5py.File(input_file, "r") if own_file else input_file
    try:
        if "mesh" in f:
            mesh = Mesh.from_hdf5(f["mesh"])
        else:
            mesh = Device.from_hdf5(f["solution/device"]).mesh
        data_min, data_max = get_data_range(f)
        if max_frame < 0:
            max_frame = data_max + 1 + max_frame
        frames = list(range(max(min_frame, data_min), max_frame + 1))
        x, y = mesh.sites.T
        if not dimensionless and "solution/device" in f:
            xi = f["solution/device/layer"].attrs["coherence_length"]
            x, y = x * xi, y * xi

        with non_gui_backend():
            fig, axes = auto_grid(len(quantities), max_cols=max_cols,
                                  **(figure_kwargs or {}))
            collections = []
            for quantity, ax in zip(quantities, np.asarray(axes).flat):
                value, _, limits = get_plot_data(f, mesh, quantity, frames[0])
                defaults = PLOT_DEFAULTS[quantity]
                pc = ax.tripcolor(x, y, value, triangles=mesh.elements,
                                  shading=shading, cmap=defaults.cmap)
                pc.set_clim(*limits)
                cbar = fig.colorbar(pc, ax=ax)
                cbar.set_label(defaults.clabel)
                ax.set_aspect("equal")
                ax.set_title(quantity.value)
                if axis_labels:
                    ax.set_xlabel(defaults.xlabel)
                    ax.set_ylabel(defaults.ylabel)
                if axes_off:
                    ax.axis("off")
                collections.append(pc)
            suptitle = None
            if not title_off:
                suptitle = fig.suptitle(
                    get_state_string(f, frames[0], frames[-1])
                )

            progress = tqdm(total=len(frames), desc="Rendering frames",
                            disable=silent)

            def update(frame):
                for quantity, pc in zip(quantities, collections):
                    value, _, limits = get_plot_data(f, mesh, quantity, frame)
                    pc.set_array(value)
                    if autoscale:
                        pc.set_clim(float(np.nanmin(value)),
                                    float(np.nanmax(value)))
                    else:
                        pc.set_clim(*limits)
                if suptitle is not None:
                    text = get_state_string(f, frame, frames[-1])
                    if not full_title:
                        text = text.split(",")[0]
                    suptitle.set_text(text)
                progress.update()
                return collections

            anim = FuncAnimation(fig, update, frames=frames, blit=False,
                                 interval=1000 / fps)
            if output_file is not None:
                kwargs = dict(fps=fps, dpi=dpi)
                if writer is not None:
                    kwargs["writer"] = writer
                anim.save(output_file, **kwargs)
                plt.close(fig)
            progress.close()
            return anim
    finally:
        if own_file:
            f.close()
