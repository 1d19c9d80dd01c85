"""The compulsory bytes of a frame's work, counted from the work itself.

Each work item counts each input it must read once and each output it must
write once, in float32 or int32 (4 bytes), whatever a kernel reads again
and whichever kernels implement it.  The counts come from the cell's shapes
(P particles, an n^3 grid) and from the frame's own counts (outer passes,
CG iterations, fluid cells), never from launches or kernel names, so they
read the same work whatever a later change fuses or removes.  The share of
the roofline is these bytes at the card's HBM rate over the device time.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 80 GB: HBM3 bandwidth from NVIDIA's data sheet, at the
# card's full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
W = 4   # bytes of a float32 or int32


def sort(p: int) -> int:
    """Stable sort by cell: read positions and velocities, write them sorted
    with their cell ids."""
    return p * (6 * W) + p * (6 * W + W)


def weights(p: int) -> int:
    """The 27-offset stencil: read the sorted positions, write the (27, P)
    table."""
    return p * 3 * W + p * 27 * W


def p2g(p: int, n: int) -> int:
    """P2G of weight and momentum: read the table once a particle (27
    weights), the velocity and the cells' particle ranges (n^3 + 1), write
    the 4 grid channels."""
    return p * 27 * W + p * 3 * W + (n ** 3 + 1) * W + 4 * n ** 3 * W


def g2p(p: int, cells: int) -> int:
    """G2P gather: read the table once a particle and its cell id, the 4
    channels of the cells read, write the 4 sums a particle."""
    return p * 27 * W + p * W + 4 * cells * W + 4 * p * W


def advect(p: int) -> int:
    """CFL and advection: read positions and velocities, write them."""
    return 2 * p * 6 * W


def cg_iteration(cells: int) -> int:
    """One CG iteration at the fluid cells: the Laplacian's diagonal read,
    the iteration's state (x, r, p) read and written once."""
    return cells * (W + 6 * W)


def outer_pass(cells: int) -> int:
    """One outer pass of the projection outside its CG: the three face
    velocities read and written at the fluid cells."""
    return cells * 6 * W


def flip_frame(p: int, n: int, fluid_cells: int, outer: int, cg: int) -> int:
    """A FLIP frame: sort, weights, P2G, the projection's passes and CG
    iterations at the frame's fluid cells, G2P, advection."""
    return (sort(p) + weights(p) + p2g(p, n) + g2p(p, fluid_cells)
            + advect(p) + outer * outer_pass(fluid_cells)
            + cg * cg_iteration(fluid_cells))


def mpm_sort(p: int) -> int:
    """Stable sort of the MPM state by cell: read positions, velocities, FE,
    FP and the volume (25 floats), write them sorted with the cell ids."""
    return p * 25 * W + p * 26 * W


def mpm_stencil(p: int) -> int:
    """The MPM stencil: read the sorted positions, write the (27, P) weights
    and the (81, P) gradients."""
    return p * 3 * W + p * 108 * W


def gw_gather(p: int, cells: int) -> int:
    """The velocity gradient: read the (81, P) gradients once a particle and
    its cell id, the 3 channels of the cells read, write the (P, 3, 3)
    result."""
    return p * 81 * W + p * W + 3 * cells * W + p * 9 * W


def force_scatter(p: int, n: int) -> int:
    """K1 fg's work, as ``PERF.md``'s kernel table counts it: read the
    (81, P) gradients and the (P, 9) matrices once, the cells' particle
    ranges, write the 3 grid channels."""
    return p * 81 * W + p * 9 * W + (n ** 3 + 1) * W + 3 * n ** 3 * W


def force_apply(p: int, n: int, cells: int) -> int:
    """One implicit apply, gather, stress differential and scatter as one
    piece of work: read the (81, P) gradients once, FE and the cell ids
    once a particle, the 3 channels at the active cells and the cells'
    particle ranges, write the 3 grid channels; with the CG state (x, r, p,
    3 channels each) read and written once at the active cells."""
    return (p * 81 * W + p * 9 * W + p * W + 3 * cells * W
            + (n ** 3 + 1) * W + 3 * n ** 3 * W + cells * 18 * W)


def mpm_frame(p: int, n: int, active_cells: int, applies: int) -> int:
    """An MPM frame: sort, stencil, P2G of mass and momentum, the density
    gather, the explicit force (read FE, the stress's inputs, and a
    scatter), ``applies`` implicit applies, the velocity gradient, the F
    update (read FE and FP, write them), the FLIP delta and advection."""
    return (mpm_sort(p) + mpm_stencil(p) + p2g(p, n)
            + g2p(p, active_cells)                      # density
            + p * 18 * W + force_scatter(p, n)          # explicit force
            + applies * force_apply(p, n, active_cells)
            + gw_gather(p, active_cells)                # velocity gradient
            + p * 36 * W                                # F update
            + g2p(p, active_cells) + advect(p))
