"""Live monitoring of a running simulation via the SWMR ``.tmp`` file.

API parity with the reference ``tdgl/visualization/monitor.py:14-166``: the
solver writes each snapshot into ``<output>.h5.tmp`` under ``data/-1`` and
flushes; this module polls that file and redraws.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional, Sequence, Union

import numpy as np

from .common import DEFAULT_QUANTITIES, PLOT_DEFAULTS, Quantity, auto_grid
from .io import get_plot_data

logger = logging.getLogger(__name__)


def monitor_solution(
    h5path: str,
    update_interval: float = 1.0,
    quantities: Union[str, Sequence[str], None] = None,
    shading: str = "gouraud",
    dimensionless: bool = False,
    max_cols: int = 4,
    figure_kwargs: Optional[dict] = None,
):
    """Poll a live ``.tmp`` output file and plot the latest state until the
    file disappears (solver finished) or the window is closed."""
    import matplotlib
    import matplotlib.pyplot as plt

    from ..device.device import Device

    if quantities is None:
        quantities = DEFAULT_QUANTITIES
    if isinstance(quantities, str):
        quantities = [quantities]
    quantities = [Quantity.from_key(str(q)) for q in quantities]

    # Wait for the file to exist.
    deadline = time.time() + 60
    while not os.path.exists(h5path) and time.time() < deadline:
        time.sleep(0.25)
    if not os.path.exists(h5path):
        raise FileNotFoundError(h5path)

    plt.ion()
    import h5py
    with h5py.File(h5path, "r", libver="latest", swmr=True) as f:
        device = Device.from_hdf5(f["solution/device"])
        mesh = device.mesh
        x, y = mesh.sites.T
        if not dimensionless:
            xi = device.layer.coherence_length
            x, y = x * xi, y * xi
        fig, axes = auto_grid(len(quantities), max_cols=max_cols,
                              **(figure_kwargs or {}))
        collections = []
        for quantity, ax in zip(quantities, np.asarray(axes).flat):
            value, _, limits = get_plot_data(f, mesh, quantity, -1)
            defaults = PLOT_DEFAULTS[quantity]
            pc = ax.tripcolor(x, y, value, triangles=mesh.elements,
                              shading=shading, cmap=defaults.cmap)
            pc.set_clim(*limits)
            cbar = fig.colorbar(pc, ax=ax)
            cbar.set_label(defaults.clabel)
            ax.set_aspect("equal")
            ax.set_title(quantity.value)
            collections.append(pc)
        suptitle = fig.suptitle("")
        while True:
            if not os.path.exists(h5path):
                break
            if not plt.fignum_exists(fig.number):
                break
            try:
                grp = f["data/-1"]
                for key in ("step", "time", "dt"):
                    grp[key].refresh()
                step = int(np.array(grp["step"])[0])
                t = float(np.array(grp["time"])[0])
                dt = float(np.array(grp["dt"])[0])
                for quantity, pc in zip(quantities, collections):
                    value, _, limits = get_plot_data(f, mesh, quantity, -1)
                    pc.set_array(value)
                    pc.set_clim(*limits)
                suptitle.set_text(f"Step {step}, time {t:.2f}, dt {dt:.2e}")
                fig.canvas.draw_idle()
                fig.canvas.flush_events()
            except (KeyError, OSError, RuntimeError) as exc:
                logger.debug("Monitor read failed: %s", exc)
            plt.pause(update_interval)
    plt.ioff()
