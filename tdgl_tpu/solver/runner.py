"""Host-side simulation runner and HDF5 data handling.

The on-disk schema matches the reference (``tdgl/solver/runner.py:29-183``):
``mesh/`` (the FV mesh), root-level fixed arrays, and per-snapshot groups
``data/<n>`` with state attrs (step/time/dt), full state arrays, and a
``running_state`` subgroup of per-step scalars. A parallel ``<file>.h5.tmp``
SWMR file with a ``data/-1`` group feeds the live monitor and is deleted on
close.

The execution model differs from the reference's per-step Python loop: the
device advances ``save_every`` steps per call to a compiled chunk function
(``lax.scan``), and the host only synchronizes at snapshot boundaries.
"""

from __future__ import annotations

import logging
import os
import subprocess
import sys
import tempfile
import traceback
from datetime import datetime
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from ..utils.jaxio import host_scalar, to_numpy, tree_to_numpy
from .options import SolverOptions
from .step import SolverState, StepOutputs

logger = logging.getLogger(__name__)


class DataHandler:
    """Context manager owning the output HDF5 file (and the SWMR tmp file)."""

    def __init__(self, output_file: Optional[str],
                 logger: Optional[logging.Logger] = None):
        self.tempdir = None
        self.save_number = 0
        self.logger = logger or logging.getLogger(__name__)
        self._base_output_file = output_file
        self.output_file: Optional[h5py.File] = None
        self.output_path: Optional[str] = None
        self.tmp_file: Optional[h5py.File] = None
        self.tmp_path: Optional[str] = None
        self.time_step_group: Optional[h5py.Group] = None
        self.mesh_group: Optional[h5py.Group] = None

    def _create_output_file(self, output: Optional[str]):
        if output is None:
            self.tempdir = tempfile.TemporaryDirectory()
            directory, name, suffix = self.tempdir.name, "output", "h5"
        else:
            Path(output).parent.mkdir(parents=True, exist_ok=True)
            parts = output.split(".")
            name, suffix = ".".join(parts[:-1]), parts[-1]
            directory = os.getcwd()
        serial = None
        while True:
            tag = f"-{serial}" if serial is not None else ""
            file_name = f"{name}{tag}.{suffix}"
            path = os.path.join(directory, file_name)
            tmp_path = path + ".tmp"
            try:
                import h5py
                f = h5py.File(path, "x")
                tmp = h5py.File(tmp_path, "x", libver="latest")
            except (OSError, FileExistsError):
                serial = 1 if serial is None else serial + 1
                continue
            if serial is not None:
                self.logger.warning(
                    f"Output file already exists; renamed to {file_name}."
                )
            return f, path, tmp, tmp_path

    def __enter__(self) -> "DataHandler":
        (self.output_file, self.output_path, self.tmp_file,
         self.tmp_path) = self._create_output_file(self._base_output_file)
        self.time_step_group = self.output_file.create_group(
            "data", track_order=True
        )
        grp = self.tmp_file.create_group("data/-1")
        grp["step"] = np.array([0])
        grp["time"] = np.array([0.0])
        grp["dt"] = np.array([0.0])
        return self

    def __exit__(self, exc_type, exc_value, exc_tb) -> None:
        if exc_value is not None:
            self.logger.warning(
                "Ignoring exception in DataHandler.__exit__():\n%s",
                "".join(traceback.format_exception(exc_type, exc_value,
                                                   exc_tb)),
            )
        self.close()

    def close(self) -> None:
        if self.output_file is not None:
            self.output_file.close()
        if self.tmp_file is not None:
            self.tmp_file.flush()
            self.tmp_file.close()
            try:
                os.remove(self.tmp_path)
            except OSError:
                pass
        if self.tempdir is not None:
            self.tempdir.cleanup()

    def save_mesh(self, mesh) -> None:
        """Save the mesh under ``mesh/``."""
        self.mesh_group = self.output_file.create_group("mesh")
        mesh.to_hdf5(self.mesh_group)

    def save_fixed_values(self, fixed_data: Dict[str, np.ndarray]) -> None:
        """Save time-independent arrays at the file root."""
        for key, value in fixed_data.items():
            value = np.asarray(value)
            self.output_file[key] = value
            self.tmp_file[key] = value

    def save_time_step(
        self,
        state: Dict[str, float],
        data: Dict[str, np.ndarray],
        running_state: Optional[Dict[str, np.ndarray]],
    ) -> None:
        """Append one snapshot group ``data/<n>``."""
        group = self.time_step_group.create_group(f"{self.save_number}")
        group.attrs["timestamp"] = datetime.now().isoformat()
        self.save_number += 1
        for key, value in state.items():
            group.attrs[key] = value
        tmp_grp = self.tmp_file["data/-1"]
        for key, value in data.items():
            value = np.asarray(value)
            group[key] = value
            if key in tmp_grp:
                tmp_grp[key][:] = value
            else:
                tmp_grp[key] = value
            tmp_grp[key].flush()
        for key in ("step", "time", "dt"):
            tmp_grp[key][:] = np.array([state[key]])
            tmp_grp[key].flush()
        if running_state is not None:
            rs_grp = group.create_group("running_state")
            for key, value in running_state.items():
                rs_grp[key] = np.squeeze(np.asarray(value))

    def save_checkpoint(self, arrays: Dict[str, np.ndarray],
                        attrs: Dict[str, object]) -> None:
        """Overwrite the single ``checkpoint`` group with the full solver
        state (see ``SolverOptions.save_checkpoints`` /
        ``solve(resume_from=...)``). Only the latest checkpoint is kept."""
        f = self.output_file
        if "checkpoint" in f:
            del f["checkpoint"]
        grp = f.create_group("checkpoint")
        for key, value in arrays.items():
            grp[key] = np.asarray(value)
        for key, value in attrs.items():
            grp.attrs[key] = value
        # Flush so the checkpoint survives a hard kill (preemption/crash):
        # an HDF5 file whose writer died between flushes can be unreadable.
        f.flush()


class RunningState:
    """Per-step scalar buffer between snapshots (cf. reference
    ``runner.py:186-221``). Shapes are ``(size, buffer_size)``."""

    def __init__(self, names_and_sizes: Dict[str, int], buffer_size: int):
        self.buffer_size = buffer_size
        self.names_and_sizes = names_and_sizes
        self.values = {
            name: np.zeros((size, buffer_size))
            for name, size in names_and_sizes.items()
        }

    def clear(self) -> None:
        self._cursor = 0
        for name, size in self.names_and_sizes.items():
            self.values[name] = np.zeros((size, self.buffer_size))

    def append_outputs(self, outputs: StepOutputs, n_valid: int,
                       include_screening: bool) -> None:
        """Append one chunk's stacked step outputs at the write cursor
        (chunks may be smaller than the save interval)."""
        start = getattr(self, "_cursor", 0)
        stop = min(start + n_valid, self.buffer_size)
        m = stop - start
        self.values["dt"][0, start:stop] = np.asarray(outputs.dt)[:m]
        if "mu" in self.values:
            self.values["mu"][:, start:stop] = (
                np.asarray(outputs.mu_probe)[:m].T
            )
            self.values["theta"][:, start:stop] = (
                np.asarray(outputs.theta_probe)[:m].T
            )
        if include_screening and "screening_iterations" in self.values:
            self.values["screening_iterations"][0, start:stop] = (
                np.asarray(outputs.screening_iterations)[:m]
            )
        self._cursor = stop


class Runner:
    """Drives the two solve stages (thermalize, simulate) chunk by chunk.

    Args:
        chunk_fn: Compiled function advancing up to ``save_every`` steps.
        initial_state: The device-resident :class:`SolverState`.
        options: Solver options.
        data_handler: Output file handler.
        state_to_arrays: Maps a :class:`SolverState` to the dict of arrays
            saved in each snapshot.
        host_update_fn: Optional callback ``state -> state`` invoked before
            every chunk (used for non-traceable time-dependent parameters;
            forces chunk size 1 upstream).
        running_names_and_sizes: Names/sizes of the per-step scalars.
    """

    def __init__(
        self,
        chunk_fn: Callable,
        initial_state: SolverState,
        options: SolverOptions,
        data_handler: DataHandler,
        state_to_arrays: Callable[[SolverState], Dict[str, np.ndarray]],
        running_names_and_sizes: Dict[str, int],
        chunk_size: int,
        initial_export: Optional[Dict[str, np.ndarray]] = None,
        host_update_fn: Optional[Callable] = None,
        monitor: bool = False,
        monitor_update_interval: float = 1.0,
        logger: Optional[logging.Logger] = None,
        checkpoint_meta: Optional[Dict[str, object]] = None,
        resume: bool = False,
    ):
        self.chunk_fn = chunk_fn
        self.state = initial_state
        self.options = options
        self.data_handler = data_handler
        self.state_to_arrays = state_to_arrays
        self.chunk_size = chunk_size
        # Host view of the latest state (updated after every chunk); the
        # initial value is built host-side so no device program is needed
        # before the first chunk.
        self._last_export = initial_export
        self.host_update_fn = host_update_fn
        self.monitor = monitor
        self.monitor_update_interval = monitor_update_interval
        self.checkpoint_meta = checkpoint_meta
        self.resume = resume
        self.logger = logger or logging.getLogger(__name__)
        self.running_state = RunningState(
            running_names_and_sizes, options.save_every
        )

    def run(self) -> bool:
        """Run thermalization (if any) then the recorded stage.

        Returns True if data was generated (i.e., the run was not cancelled
        during thermalization).
        """
        import contextlib

        import jax
        import jax.numpy as jnp

        options = self.options
        trace_cm = (
            jax.profiler.trace(options.profile_dir)
            if options.profile_dir else contextlib.nullcontext()
        )
        with trace_cm:
            return self._run_stages()

    def _run_stages(self) -> bool:
        import jax.numpy as jnp

        options = self.options
        if options.skip_time and self.resume:
            self.logger.warning(
                "skip_time is ignored when resuming from a checkpoint"
                " (the checkpointed run already thermalized)."
            )
        if options.skip_time and not self.resume:
            ok = self._run_stage("Thermalizing", options.skip_time,
                                 save=False)
            if not ok:
                return False
            # Reset the clock and step counter; the adaptive tentative_dt
            # carries over (as in the reference, ``runner.py:315-318``).
            self.state = self.state._replace(
                time=jnp.zeros_like(self.state.time),
                step=jnp.zeros_like(self.state.step),
                prev_dt=jnp.asarray(options.dt_init, self.state.prev_dt.dtype),
                done=jnp.array(False),
            )
            # Patch the host view's scalar diagnostics to the reset values.
            diag = np.array(self._last_export["diagnostics"])
            diag[0] = 0.0           # time
            diag[1] = options.dt_init  # prev_dt
            diag[3] = 0.0           # step
            diag[4] = 0.0           # done
            self._last_export = dict(self._last_export, diagnostics=diag)
        self._run_stage("Simulating", options.solve_time, save=True)
        return True

    # -- internals -----------------------------------------------------------
    def _save_snapshot(self, running_state: Optional[Dict[str, np.ndarray]]
                       ) -> None:
        exported = dict(self._last_export)
        diag = exported.pop("diagnostics")
        attrs = dict(step=int(diag[3]), time=float(diag[0]),
                     dt=float(diag[1]))
        self.data_handler.save_time_step(
            attrs, self.state_to_arrays(exported), running_state
        )

    def _save_checkpoint(self) -> None:
        """Fetch the full device state and overwrite the file's single
        ``checkpoint`` group (exact-resume support). 0-d fields (time,
        step, dts, flags) go to attrs; arrays to datasets."""
        if not self.options.save_checkpoints or self.checkpoint_meta is None:
            return
        state_np = tree_to_numpy(self.state)._asdict()
        arrays, attrs = {}, dict(self.checkpoint_meta)
        for name, value in state_np.items():
            value = np.asarray(value)
            if value.ndim == 0:
                attrs[name] = value.item()
            else:
                arrays[name] = value
        self.data_handler.save_checkpoint(arrays, attrs)

    def _start_monitor(self) -> None:
        if self.data_handler.tmp_file is not None:
            self.data_handler.tmp_file.swmr_mode = True
            if self.monitor:
                cmd = [
                    sys.executable, "-m", "tdgl_tpu.visualize",
                    "--input", self.data_handler.output_path,
                    "monitor", "--interval",
                    str(self.monitor_update_interval),
                ]
                subprocess.Popen(cmd, start_new_session=True)

    def _run_stage(self, name: str, end_time: float, save: bool) -> bool:
        import jax
        import jax.numpy as jnp

        options = self.options
        state = self.state._replace(
            end_time=jnp.asarray(end_time, self.state.time.dtype),
            done=jnp.array(False),
        )
        self.state = state
        prog_disabled = options.progress_interval > 0
        cancelled = False
        monitor_started = False
        import time as _time
        last_report = _time.perf_counter()
        steps_at_report = 0

        from tqdm import tqdm
        with tqdm(total=float(end_time), desc=name, unit="tau",
                  disable=prog_disabled, dynamic_ncols=True) as pbar:
            if save:
                self._save_snapshot(None)  # step-0 snapshot, no running state
                self._start_monitor()
                monitor_started = True
            prev_time = 0.0
            while True:
                try:
                    if self.host_update_fn is not None:
                        self.state = self.host_update_fn(self.state)
                    self.state, outputs, exported = self.chunk_fn(self.state)
                    outputs = tree_to_numpy(outputs)
                    self._last_export = tree_to_numpy(exported)
                    n_valid = int(np.sum(outputs.valid))
                    diag = self._last_export["diagnostics"]
                    if bool(diag[5]):
                        raise RuntimeError(
                            f"Solver failed to converge at step"
                            f" {int(diag[3])} of stage"
                            f" {name!r}: the time step underflowed"
                            f" ({options.max_solve_retries} retries) or the"
                            " screening iteration hit"
                            f" {options.max_iterations_per_step} iterations."
                            " Try a smaller dt_init."
                        )
                    now = float(diag[0])
                    pbar.update(min(now, end_time) - min(prev_time, end_time))
                    prev_time = now
                    if prog_disabled:
                        step_now = int(diag[3])
                        t = _time.perf_counter()
                        rate = (step_now - steps_at_report) / max(
                            t - last_report, 1e-9
                        )
                        last_report, steps_at_report = t, step_now
                        self.logger.info(
                            f"{name}: Time {now:.3f}/{end_time},"
                            f" {rate:.2f} it/s"
                        )
                    done = bool(diag[4])
                    if save and n_valid:
                        self.running_state.append_outputs(
                            outputs, n_valid, options.include_screening
                        )
                    step_now = int(diag[3])
                    at_boundary = (step_now % options.save_every) == 0
                    if save and n_valid and (at_boundary or done
                                             or n_valid < self.chunk_size):
                        self._save_snapshot(dict(self.running_state.values))
                        self.running_state.clear()
                        self._save_checkpoint()
                    if done or n_valid < self.chunk_size:
                        break
                except KeyboardInterrupt:
                    step_now = (int(self._last_export["diagnostics"][3])
                                if self._last_export is not None else -1)
                    msg = f"{{}} simulation at step {step_now} of stage {name!r}."
                    if options.pause_on_interrupt:
                        response = input(
                            f"Simulation paused at stage {name!r}"
                            f" (step {step_now}). Continue? [yN]"
                        )
                        if response.lower().startswith("y"):
                            self.logger.info(msg.format("Resuming"))
                            continue
                    self.logger.warning(msg.format("Cancelling"))
                    cancelled = True
                    break
        if save and not monitor_started:
            self._start_monitor()
        return not cancelled
