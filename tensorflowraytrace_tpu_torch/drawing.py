"""Drawing: matplotlib drawers for rays, boundaries and goals, and the
drawable ray data of a trace.

Counterpart of ``tensorflowraytrace_tpu/drawing.py`` (the reference's
drawing.py, with mplot3d in place of pyvista for 3D):

  RED..PURPLE, RAINBOW_6     re-exported from ops.spectrum
  form_mpl_line_syntax       a ray set as line segments
  spectrum_colormap          the visible spectrum as a colormap
  RayDrawer2D, RayDrawer3D   rays coloured by wavelength
  SegmentDrawer, ArcDrawer   2D boundaries with normal arrows
  TriangleDrawer             a triangle mesh with normal and parameter
                             arrows (the parametric boundaries'
                             params_to_vertices, zero and vectors)
  GoalDrawer3D               arrows from trace outputs to goal points
  history_rays               a trace's per-bounce history as one ray dict
  figure                     a Figure outside pyplot, for writing PNGs
  disable_figure_key_commands, redraw_current_figure

Every drawer takes the port's tensors on any device, with or without a
gradient, as well as dicts, NumPy arrays and the facade's ``ReadOnlySet``:
they are drawn from host copies.  matplotlib is imported by the drawers
when they are made, never when this module is imported (``system.py``
imports ``history_rays``, and a machine without matplotlib still runs the
facade).  The JAX package's pyvista drawers are not ported.
"""

from __future__ import annotations

import math

import numpy as np

from tensorflowraytrace_tpu_torch.ops.spectrum import (  # noqa: F401 (re-exports)
    BLUE, GREEN, ORANGE, PURPLE, RAINBOW_6, RED, VISIBLE_MAX, VISIBLE_MIN,
    YELLOW, rgb,
)

PI = math.pi
UNIT_TO_NUMBER = {"nm": 1, "um": 1000}


def host_array(t):
    """A host NumPy array of a tensor (any device, with or without a
    gradient), an array or a sequence."""
    if hasattr(t, "detach"):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _get(rays, key):
    """Field access that works for the port's sets, dicts and the facade's
    ``ReadOnlySet``, as a host array."""
    return host_array(rays[key])


def _mpl():
    import matplotlib as mpl
    import matplotlib.collections  # noqa: F401 (mpl.collections)
    import matplotlib.colors  # noqa: F401 (mpl.colors)
    import matplotlib.patches  # noqa: F401 (mpl.patches)

    return mpl


def _pyplot():
    import matplotlib.pyplot as plt

    return plt


def figure(**kwargs):
    """A matplotlib ``Figure`` made outside pyplot: no backend is chosen
    and nothing global changes, so a function can write a PNG
    (``fig.savefig(path)``) headless, in any process."""
    from matplotlib.figure import Figure

    return Figure(**kwargs)


def form_mpl_line_syntax(rays):
    """Ray set -> list of [(x0, y0), (x1, y1)] segments."""
    xs = _get(rays, "x_start")
    ys = _get(rays, "y_start")
    xe = _get(rays, "x_end")
    ye = _get(rays, "y_end")
    return [[(a, b), (c, d)] for a, b, c, d in zip(xs, ys, xe, ye)]


def spectrum_colormap():
    mpl = _mpl()
    return mpl.colors.ListedColormap(host_array(rgb()))


class RayDrawer2D:
    """Draw 2D rays into an mpl axis as a LineCollection coloured by
    wavelength."""

    def __init__(self, ax, rays=None, min_wavelength=VISIBLE_MIN,
                 max_wavelength=VISIBLE_MAX, units="nm", style="-",
                 colormap=None):
        mpl = _mpl()
        self.ax = ax
        self.rays = rays
        self._style = style
        try:
            self._unit = UNIT_TO_NUMBER[units]
        except KeyError as e:
            raise ValueError(f"RayDrawer: invalid units {units!r}; use 'nm' "
                             "or 'um'") from e
        self._line_collection = mpl.collections.LineCollection(
            [], linestyles=style, cmap=colormap or spectrum_colormap())
        self.set_wavelength_limits(min_wavelength, max_wavelength)
        self.ax.add_collection(self._line_collection)

    def draw(self):
        if self.rays is None or len(_get(self.rays, "x_start")) == 0:
            self._line_collection.set_segments([])
            return
        self._line_collection.set_segments(form_mpl_line_syntax(self.rays))
        self._line_collection.set_array(
            self._unit * _get(self.rays, "wavelength"))

    def set_wavelength_limits(self, lo, hi):
        self._line_collection.norm = _mpl().colors.Normalize(self._unit * lo,
                                                   self._unit * hi)


class SegmentDrawer:
    """Draw 2D segment boundaries with optional normal arrows.  Accepts a
    SegmentSet or a field dict."""

    def __init__(self, ax, segments=None, color="black", style="-",
                 draw_norm_arrows=True, norm_arrow_length=0.1):
        mpl = _mpl()
        self.ax = ax
        self.segments = segments
        self.color = color
        self.draw_norm_arrows = draw_norm_arrows
        self.norm_arrow_length = norm_arrow_length
        self._line_collection = mpl.collections.LineCollection(
            [], colors=color, linestyles=style)
        self.ax.add_collection(self._line_collection)
        self._arrows = []

    def draw(self):
        for a in self._arrows:
            a.remove()
        self._arrows = []
        if self.segments is None:
            self._line_collection.set_segments([])
            return
        self._line_collection.set_segments(
            form_mpl_line_syntax(self.segments))
        if self.draw_norm_arrows:
            xs = _get(self.segments, "x_start")
            ys = _get(self.segments, "y_start")
            xe = _get(self.segments, "x_end")
            ye = _get(self.segments, "y_end")
            cx = (xs + xe) / 2
            cy = (ys + ye) / 2
            theta = np.arctan2(ye - ys, xe - xs) + PI / 2
            L = self.norm_arrow_length
            for x, y, t in zip(cx, cy, theta):
                self._arrows.append(self.ax.annotate(
                    "", xy=(x + L * np.cos(t), y + L * np.sin(t)),
                    xytext=(x, y),
                    arrowprops=dict(arrowstyle="->", color=self.color)))


class ArcDrawer:
    """Draw 2D arc boundaries with optional normal arrows.  Accepts an
    ArcSet or a field dict."""

    def __init__(self, ax, arcs=None, color="cyan", style="-",
                 draw_norm_arrows=True, norm_arrow_count=5,
                 norm_arrow_length=0.1):
        _mpl()
        self.ax = ax
        self.arcs = arcs
        self.color = color
        self.style = style
        self.draw_norm_arrows = draw_norm_arrows
        self.norm_arrow_count = norm_arrow_count
        self.norm_arrow_length = norm_arrow_length
        self._patches = []
        self._arrows = []

    def draw(self):
        mpl = _mpl()
        for p in self._patches:
            p.remove()
        for a in self._arrows:
            a.remove()
        self._patches = []
        self._arrows = []
        if self.arcs is None:
            return
        xc = _get(self.arcs, "x_center")
        yc = _get(self.arcs, "y_center")
        a0 = _get(self.arcs, "angle_start")
        a1 = _get(self.arcs, "angle_end")
        r = _get(self.arcs, "radius")
        for x, y, s, e, rad in zip(xc, yc, a0, a1, r):
            arc = mpl.patches.Arc(
                (x, y), 2 * abs(rad), 2 * abs(rad),
                theta1=np.degrees(s), theta2=np.degrees(e),
                color=self.color, linestyle=self.style, fill=False)
            self.ax.add_patch(arc)
            self._patches.append(arc)
            if self.draw_norm_arrows:
                # the normal points outward for a positive radius, inward
                # for a negative one
                span = (e - s) % (2 * PI) or 2 * PI
                angles = s + span * np.linspace(0.1, 0.9,
                                                self.norm_arrow_count)
                sign = 1.0 if rad >= 0 else -1.0
                L = self.norm_arrow_length
                for t in angles:
                    px = x + abs(rad) * np.cos(t)
                    py = y + abs(rad) * np.sin(t)
                    self._arrows.append(self.ax.annotate(
                        "", xy=(px + sign * L * np.cos(t),
                                py + sign * L * np.sin(t)),
                        xytext=(px, py),
                        arrowprops=dict(arrowstyle="->", color=self.color)))


class RayDrawer3D:
    """Draw 3D rays into an mplot3d axis, coloured by wavelength."""

    def __init__(self, ax, rays=None, min_wavelength=VISIBLE_MIN,
                 max_wavelength=VISIBLE_MAX, colormap=None):
        mpl = _mpl()
        from mpl_toolkits.mplot3d.art3d import Line3DCollection

        self.ax = ax
        self.rays = rays
        self._collection = Line3DCollection(
            [], cmap=colormap or spectrum_colormap())
        self._collection.norm = mpl.colors.Normalize(min_wavelength,
                                                    max_wavelength)
        # autolim=False: matplotlib's autoscale fails on an empty 3D
        # collection; callers set their own axis limits
        self.ax.add_collection3d(self._collection, autolim=False)

    def draw(self):
        if self.rays is None or len(_get(self.rays, "x_start")) == 0:
            self._collection.set_segments([])
            return
        p0 = np.stack([_get(self.rays, "x_start"), _get(self.rays, "y_start"),
                       _get(self.rays, "z_start")], axis=1)
        p1 = np.stack([_get(self.rays, "x_end"), _get(self.rays, "y_end"),
                       _get(self.rays, "z_end")], axis=1)
        self._collection.set_segments(np.stack([p0, p1], axis=1))
        self._collection.set_array(_get(self.rays, "wavelength"))


class TriangleDrawer:
    """Draw a triangle boundary or mesh with optional normal arrows and
    parameter arrows.  Accepts a TriangleSet, a TriMesh, or anything with
    ``xp`` .. ``z2`` fields.

    The parameter arrows, one a vertex along the direction its parameter
    moves it, need ``boundary``, a parametric boundary
    (``models/boundaries.py``) with ``vectors`` and ``params_to_vertices``,
    and ``params``, its current parameters (None: its ``zero`` mesh)."""

    def __init__(self, ax, surface=None, color="cyan", show_edges=False,
                 draw_norm_arrows=False, norm_arrow_length=0.1, alpha=0.7,
                 draw_parameter_arrows=False, parameter_arrow_length=0.1,
                 boundary=None, params=None):
        _mpl()
        self.ax = ax
        self.surface = surface
        self.color = color
        self.show_edges = show_edges
        self.draw_norm_arrows = draw_norm_arrows
        self.norm_arrow_length = norm_arrow_length
        self.alpha = alpha
        self.draw_parameter_arrows = draw_parameter_arrows
        self.parameter_arrow_length = parameter_arrow_length
        self.boundary = boundary
        self.params = params
        self.norm_arrow_visibility = True
        self.parameter_arrow_visibility = True
        self._poly = None
        self._quiver = None
        self._param_quiver = None

    def toggle_norm_arrow_visibility(self):
        self.norm_arrow_visibility = not self.norm_arrow_visibility
        self.draw()

    def toggle_parameter_arrow_visibility(self):
        self.parameter_arrow_visibility = not self.parameter_arrow_visibility
        self.draw()

    def _triangles(self):
        s = self.surface
        if hasattr(s, "points") and hasattr(s, "faces"):  # TriMesh
            return host_array(s.points)[host_array(s.faces)]
        vp = np.stack([_get(s, "xp"), _get(s, "yp"), _get(s, "zp")], axis=1)
        v1 = np.stack([_get(s, "x1"), _get(s, "y1"), _get(s, "z1")], axis=1)
        v2 = np.stack([_get(s, "x2"), _get(s, "y2"), _get(s, "z2")], axis=1)
        return np.stack([vp, v1, v2], axis=1)

    def draw(self):
        from mpl_toolkits.mplot3d.art3d import Poly3DCollection

        for name in ("_poly", "_quiver", "_param_quiver"):
            artist = getattr(self, name)
            if artist is not None:
                artist.remove()
                setattr(self, name, None)
        if self.surface is None:
            return
        tris = self._triangles()
        self._poly = Poly3DCollection(
            tris, facecolor=self.color, alpha=self.alpha,
            edgecolor="black" if self.show_edges else None)
        self.ax.add_collection3d(self._poly)
        if self.draw_norm_arrows and self.norm_arrow_visibility:
            centers = tris.mean(axis=1)
            n = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 1])
            n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-30)
            self._quiver = self.ax.quiver(
                centers[:, 0], centers[:, 1], centers[:, 2],
                n[:, 0], n[:, 1], n[:, 2],
                length=self.norm_arrow_length, color=self.color)
        if (self.draw_parameter_arrows and self.parameter_arrow_visibility
                and self.boundary is not None):
            b = self.boundary
            if self.params is not None:
                verts = host_array(b.params_to_vertices(self.params))
            else:
                verts = host_array(b.zero)
            vecs = host_array(b.vectors)
            self._param_quiver = self.ax.quiver(
                verts[:, 0], verts[:, 1], verts[:, 2],
                vecs[:, 0], vecs[:, 1], vecs[:, 2],
                length=self.parameter_arrow_length, color="red")


class GoalDrawer3D:
    """Draw arrows from trace outputs to their goal points."""

    def __init__(self, ax, color="green"):
        _mpl()
        self.ax = ax
        self.color = color
        self.output = None
        self.goal = None
        self._quiver = None

    def draw(self):
        if self._quiver is not None:
            self._quiver.remove()
            self._quiver = None
        if self.output is None or self.goal is None:
            return
        out = host_array(self.output)
        d = host_array(self.goal) - out
        self._quiver = self.ax.quiver(
            out[:, 0], out[:, 1], out[:, 2], d[:, 0], d[:, 1], d[:, 2],
            color=self.color)


def history_rays(result, bounce=None):
    """Every ray segment of ``result``'s per-bounce history as one dict
    (``x_start``, ``y_start``, ``x_end``, ``y_end``, ``wavelength``, and
    ``z_start`` / ``z_end`` in 3D), bounce by bounce, each slot only for
    the bounces it was still live in; ``bounce`` picks one bounce."""
    if result.history_p0 is None:
        raise ValueError("trace was run without keep_history=True")
    p0 = host_array(result.history_p0)
    p1 = host_array(result.history_p1)
    alive = host_array(result.history_alive)
    wl = np.broadcast_to(host_array(result.rays.wavelength), alive.shape)
    if bounce is not None:
        sel = alive[bounce]
        return _ray_dict(p0[bounce][sel], p1[bounce][sel], wl[bounce][sel])
    mask = alive.reshape(-1)
    dim = p0.shape[-1]
    return _ray_dict(p0.reshape(-1, dim)[mask], p1.reshape(-1, dim)[mask],
                     wl.reshape(-1)[mask])


def _ray_dict(p0, p1, wl):
    out = {"x_start": p0[:, 0], "y_start": p0[:, 1],
           "x_end": p1[:, 0], "y_end": p1[:, 1], "wavelength": wl}
    if p0.shape[1] == 3:
        out["z_start"] = p0[:, 2]
        out["z_end"] = p1[:, 2]
    return out


def disable_figure_key_commands():
    """Clear matplotlib's default key bindings."""
    plt = _pyplot()
    for key in plt.rcParams:
        if "keymap" in key:
            plt.rcParams[key] = []


def redraw_current_figure():
    _pyplot().gcf().canvas.draw()
