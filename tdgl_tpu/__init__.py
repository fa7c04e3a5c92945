"""tdgl_tpu: a JAX time-dependent Ginzburg-Landau framework for accelerators.

A from-scratch JAX/XLA implementation of the capabilities of pyTDGL
(reference: loganbvh/py-tdgl): finite-volume gTDGL dynamics of superconducting
thin films on unstructured triangular meshes, with transport terminals,
magnetic screening, post-processing and visualization — with the entire hot
path (implicit Euler psi update, CG Poisson solve, screening kernel, adaptive
time stepping) fused into compiled XLA programs.
"""

from .about import version_dict, version_table
from .device.device import Device
from .device.layer import Layer
from .device.meshing import generate_mesh
from .device.polygon import Polygon
from .em import convert_field
from .fluxoid import Fluxoid, make_fluxoid_polygons
from .geometry import box, circle, ellipse, close_curve, path_vectors, rotate
from .parameter import CompositeParameter, Constant, Parameter
from .solution.data import (
    DynamicsData,
    TDGLData,
    get_current_through_paths,
)
from .solution.plot_solution import (
    plot_current_through_paths,
    plot_currents,
    plot_field_at_positions,
    plot_order_parameter,
    plot_scalar_potential,
    plot_vorticity,
)
from .solution.solution import BiotSavartField, BoundaryPhases, Solution
from .solver.options import SolverOptions, SolverOptionsError, SparseSolver
from .solver.solve import solve
from .solver.solver import SolverResult, TDGLSolver, jittable
from .sources import ConstantField, CurrentLoop, LinearRamp, Scale
from .utils.units import Quantity, UnitRegistry, ureg
from .version import __git_revision__, __version__, __version_info__
from .visualization.common import non_gui_backend
from . import em, fluxoid, geometry, parallel, sources, visualization
