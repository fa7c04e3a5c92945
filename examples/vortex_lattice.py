"""Example: field-cooled vortex lattice in a square film with a hole.

Run:  python examples/vortex_lattice.py
Produces vortex_lattice.png and vortex_lattice.h5.
"""

import numpy as np

import tdgl_tpu as tdgl
from tdgl_tpu.geometry import box, circle


def main():
    layer = tdgl.Layer(
        coherence_length=0.5,   # um
        london_lambda=2.0,      # um
        thickness=0.05,         # um
        conductivity=10.0,      # S/um
    )
    film = tdgl.Polygon("film", points=box(12)).resample(300)
    hole = tdgl.Polygon("hole", points=circle(1.0, center=(2, 2)))
    device = tdgl.Device(
        "vortex_demo", layer=layer, film=film, holes=[hole],
        probe_points=[(-4, 0), (4, 0)], length_units="um",
    )
    # structured=True -> the gather-free stencil solver backend (the fast
    # path); drop it for a boundary-conforming unstructured mesh.
    device.make_mesh(min_points=4000, structured=True)

    options = tdgl.SolverOptions(
        solve_time=20,
        save_every=200,
        field_units="mT",
        current_units="uA",
        output_file="vortex_lattice.h5",
    )
    solution = tdgl.solve(device, options, applied_vector_potential=0.8)

    fluxoid = solution.hole_fluxoid("hole")
    total = fluxoid.flux_part.magnitude + fluxoid.supercurrent_part.magnitude
    print(f"Hole fluxoid: {total:.3f} Phi_0")
    print(f"Magnetic moment: {solution.magnetic_moment(units='uA * um**2')}")

    fig, _ = solution.plot_order_parameter()
    fig.savefig("vortex_lattice.png", dpi=150)
    print("Wrote vortex_lattice.png; browse frames with:")
    print(f"  python -m tdgl_tpu.visualize --input {solution.path} interactive")


if __name__ == "__main__":
    main()
