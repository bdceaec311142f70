"""The Visualizer: loader, store, renderer, colormap, overlays and canvas.

Counterpart of ``VisualizerBase`` in ``topsy_tpu/visualizer.py`` for every
render mode on one device (``univariate``, ``bivariate``, ``rgb``,
``rgb-hdr`` and ``surface``, each in EXPORT and interactive frames, and
periodic tiling): ``get_sph_image``, ``get_sph_presentation_image``,
``get_presentation_image``, ``get_depth_image`` (the double-click pick),
``draw(reason, target=...)`` with its refine chain (a CHANGE or REFINE
draw that leaves the progression incomplete requests a REFINE draw),
``rotate``, ``prevent_sph_rendering``, the mode switch with its canvas
capability check and its revert on failure, ``canvas_format`` (float16
presentation for ``rgb-hdr``) and the ``render_mode`` / ``scale`` /
``rotation_matrix`` / ``position_offset`` / ``quantity_name`` / ``averaging``
properties, the host shell around the image (the status line of fps,
downsampling and geometry factor, ``display_status``, the crosshairs of a
shift-drag, the periodic box's wireframe, ``save`` to ``.npy``, float16
``.tif`` / ``.tiff`` or a matplotlib figure, ``show`` and the notebook
display) and, on ``Visualizer``, the view synchroniser's mixin.
``splat_backend``
(``"atlas"``, the default, or ``"scatter"``) is handed to every renderer.
The device is explicit: ``device="cuda"`` (the default) needs a GPU and
raises without one; tests pass ``"cpu"``.  The canvas and overlays are the
port's copies of the reference's classes; the colorbar (which needs
matplotlib) is built on first use.  Where matplotlib is not installed
the presentation draws no text overlay (colorbar, scale bar, status
line: each is a matplotlib raster) and says so once in the log; the
status text is still kept up to date.  Where nothing composites on the
host, the presented uint8 frame is made on the renderer's device and
only it is read back.  ``OffscreenCanvas``
and ``DrawReason`` are re-exported here for callers of the port.
``mesh`` (``parallel.make_mesh``) renders every mode over a particle
mesh through the renderers of ``render/distributed.py``; the mesh's first
shard must be ``device``, which holds the store.
"""

from __future__ import annotations

import functools
import logging
import time
from contextlib import contextmanager

import numpy as np
import torch

from . import canvas as canvas_module
from . import config
from .camera import x_rotation_matrix, y_rotation_matrix
from .canvas import OffscreenCanvas
from .color import ColormapHolder
from .color.maps import fit_to_window
from .drawreason import DrawReason
from .loaders import AbstractDataLoader, TestDataLoader
from .overlays.line import Line, SimCube
from .overlays.scalebar import ScalebarOverlay
from .overlays.text import TextOverlay
from .performance import counters, signposter
from .render import periodic, sph, surface
from .render.store import ParticleStore
from .view_synchronizer import SynchronizationMixin

logger = logging.getLogger(__name__)

VALID_RENDER_MODES = ("univariate", "bivariate", "rgb", "rgb-hdr", "surface")


@functools.cache
def text_overlays_available() -> bool:
    """Whether matplotlib, which rasterizes the text overlays, imports."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        logger.warning("matplotlib is not installed: presentations draw no "
                       "colorbar, scale bar or status line")
        return False
    return True


def quantize_rgba8_host(img: np.ndarray) -> np.ndarray:
    """The presented 8-bit levels of a float32 RGBA: clipped to [0, 1],
    scaled by 255, offset by 0.5 and truncated."""
    return (np.clip(img, 0.0, 1.0) * 255 + 0.5).astype(np.uint8)


def quantize_rgba8(img: torch.Tensor) -> torch.Tensor:
    """The opaque presented frame of a float32 RGBA on its device, as a
    C-contiguous uint8 tensor: byte for byte ``quantize_rgba8_host`` of
    the image with alpha 1.  The clamp, the scale and the offset are
    separate float32 operations, as numpy's are, and the cast truncates
    as ``astype(np.uint8)`` does."""
    frame = (img.clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8).contiguous()
    frame[..., 3] = 255
    return frame


def resolve_device(device) -> torch.device:
    """The torch device for ``device``; a CUDA device must exist (there is
    no silent move to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but no CUDA device is available; "
                           "pass device='cpu' to render on the CPU")
    return dev


class VisualizerBase:
    colorbar_aspect_ratio = config.COLORBAR_ASPECT_RATIO
    show_status = True

    def __init__(self, data_loader_class=TestDataLoader, data_loader_args=(),
                 data_loader_kwargs=None, *,
                 render_resolution=config.DEFAULT_RESOLUTION,
                 periodic_tiling=False,
                 colormap_name=config.DEFAULT_COLORMAP,
                 canvas_class=None,
                 render_mode="univariate",
                 splat_backend=None,
                 mesh=None,
                 device="cuda"):
        if render_mode is None:
            render_mode = "univariate"
        self._validate_render_mode(render_mode)
        self._render_mode = render_mode
        self._periodic_tiling = periodic_tiling
        self._splat_backend = splat_backend
        self.device = resolve_device(device)
        self._mesh = mesh
        if mesh is not None:
            from .render.distributed import same_device
            if not same_device(mesh.first_device, self.device):
                raise ValueError(f"the mesh's first shard is on "
                                 f"{mesh.first_device}, device={device}: "
                                 "they must agree")
        self._render_resolution = render_resolution
        self._colorbar = None
        self._colorbar_wanted = False
        self._sph = None
        self._prevent_sph_rendering = False
        self._colormap: ColormapHolder | None = None
        self.crosshairs_visible = False
        self.show_colorbar = True
        self.show_scalebar = True
        self._last_status_update = 0.0
        self.last_frame: np.ndarray | None = None

        if canvas_class is None:
            canvas_class = canvas_module.canvas_class_for_environment()
        self.canvas = canvas_class(visualizer=self, title="topsy_tpu_torch")

        self.data_loader: AbstractDataLoader = data_loader_class(
            *data_loader_args, **(data_loader_kwargs or {}))
        self.store = ParticleStore(self.data_loader, device=self.device)
        self.periodicity_scale = self.data_loader.get_periodicity_scale()

        self._initialize_overlays()
        self._initialize_sph_and_colormap_and_bar(colormap_name)

    # -- construction helpers ---------------------------------------------------

    def _initialize_overlays(self):
        self._status = TextOverlay(self, "topsy_tpu_torch", (-0.9, 0.9), 40,
                                   color=(1, 1, 1, 1))
        self._scalebar = ScalebarOverlay(self)
        self._crosshairs = Line(self,
                                [(-1, 0, 0, 0), (1, 0, 0, 0), (200, 200, 0, 0),
                                 (0, 1, 0, 0), (0, -1, 0, 0)],
                                (1, 1, 1, 0.3), 10.0)
        self._cube = SimCube(self, (1, 1, 1, 0.3), 10.0)

    def _renderer_class_for_mode(self, render_mode):
        if self._mesh is not None:
            from .render import distributed
            if render_mode in ("rgb", "rgb-hdr"):
                return distributed.DistributedRGBSPHRenderer
            if render_mode == "surface":
                return distributed.DistributedSurfaceSPHRenderer
            return distributed.DistributedSPHRenderer
        if render_mode in ("rgb", "rgb-hdr"):
            return sph.RGBSPHRenderer
        if render_mode == "surface":
            return surface.SurfaceSPHRenderer
        return sph.SPHRenderer

    def _colormap_parameters_for_mode(self, render_mode):
        params = {"weighted_average": self.quantity_name is not None}
        if render_mode == "rgb":
            params.update({"type": "rgb", "hdr": False, "log": True})
        elif render_mode == "rgb-hdr":
            params.update({"type": "rgb", "hdr": True, "log": True})
        elif render_mode == "bivariate":
            params.update({"type": "bivariate"})
        elif render_mode == "surface":
            params.update({"type": "surface"})
        else:
            params.update({"type": "density"})
        return params

    def _initialize_sph_and_colormap_and_bar(self, colormap_name=None):
        # a canvas that cannot present the mode's format fails the switch
        # here, before anything is built (``_update_render_mode`` reverts)
        fmt = self.canvas_format
        supported = self.canvas.supported_formats()
        if fmt not in supported:
            raise ValueError(
                f"canvas {type(self.canvas).__name__} cannot present "
                f"{fmt!r} (supports {supported}); render mode "
                f"{self._render_mode!r} unavailable")
        if self._sph is not None:
            old_rotation = self._sph.rotation_matrix
            old_position = self._sph.position_offset
            old_scale = self._sph.scale
        else:
            old_rotation = old_position = old_scale = None
        progression = self.data_loader.get_render_progression()
        mesh_args = () if self._mesh is None else (self._mesh,)
        if self._periodic_tiling:
            if self._mesh is None:
                periodic_class = periodic.PeriodicSPHRenderer
            else:
                from .render.distributed import \
                    DistributedPeriodicSPHRenderer as periodic_class
            self._sph = periodic_class(
                self.store, progression, self._render_resolution,
                *mesh_args, self.periodicity_scale,
                backend=self._splat_backend)
        else:
            renderer_class = self._renderer_class_for_mode(self._render_mode)
            self._sph = renderer_class(self.store, progression,
                                       self._render_resolution, *mesh_args,
                                       backend=self._splat_backend)
        self.reset_view(rotation_matrix=old_rotation,
                        position_offset=old_position, scale=old_scale)
        self.invalidate()

        if colormap_name is None and self._colormap is not None:
            colormap_name = self._colormap.get_parameter("colormap_name")
        if colormap_name is None:
            colormap_name = config.DEFAULT_COLORMAP
        self._colormap = ColormapHolder()
        self._colormap.update_parameters({"colormap_name": colormap_name})
        self._initialize_colormap_and_bar()

    def _initialize_colormap_and_bar(self):
        changed_type = self._colormap.update_parameters(
            self._colormap_parameters_for_mode(self._render_mode))
        params = self._colormap.get_parameters()
        if (changed_type or params.get("vmin") is None
                or params.get("vmax") is None):
            logger.info("Autoranging colormap parameters")
            # the range is taken from a render of the view, the first
            # EXPORT when the renderer has not rendered yet
            with signposter.use_interval("topsy.autorange"):
                self._colormap.autorange(self._sph.get_image_device())
        self._colorbar = None
        self._colorbar_wanted = (
            params["type"] not in ("rgb", "surface")
            or (params["type"] == "surface"
                and bool(params.get("weighted_average"))))

    def _get_colorbar_label(self):
        label = self.data_loader.get_quantity_label(self.quantity_name)
        if self._colormap.get_parameter("log"):
            label = r"$\log_{10}$ " + label
        return label

    def _colorbar_overlay(self):
        if self._colorbar is None and self._colorbar_wanted:
            from .overlays.colorbar import ColorbarOverlay
            params = self._colormap.get_parameters()
            self._colorbar = ColorbarOverlay(self, params["vmin"],
                                             params["vmax"],
                                             params["colormap_name"],
                                             self._get_colorbar_label())
        return self._colorbar

    # -- properties --------------------------------------------------------------

    @property
    def colormap(self) -> ColormapHolder:
        return self._colormap

    @property
    def render_mode(self) -> str:
        return self._render_mode

    @render_mode.setter
    def render_mode(self, value):
        """Switch modes: a new renderer and colormap over the same store
        (the presort is reused)."""
        self._update_render_mode(value)

    @staticmethod
    def _validate_render_mode(render_mode):
        if render_mode not in VALID_RENDER_MODES:
            raise ValueError(f"Invalid render_mode '{render_mode}'. "
                             f"Valid modes: {set(VALID_RENDER_MODES)}")

    def _update_render_mode(self, new_render_mode, revert_on_failure=True):
        """A failed switch (a canvas that cannot present the mode) reverts
        to the previous mode and re-raises."""
        self._validate_render_mode(new_render_mode)
        old_render_mode = self._render_mode
        self._render_mode = new_render_mode
        try:
            self._initialize_sph_and_colormap_and_bar()
        except Exception:
            if revert_on_failure:
                logger.error("Failed to switch to render mode %r; reverting "
                             "to %r", new_render_mode, old_render_mode)
                self._update_render_mode(old_render_mode,
                                         revert_on_failure=False)
            raise
        self.invalidate(DrawReason.CHANGE)

    @property
    def canvas_format(self) -> str:
        return ("rgba16float" if self._render_mode.endswith("hdr")
                else "rgba8unorm")

    @property
    def rotation_matrix(self):
        return self._sph.rotation_matrix

    @rotation_matrix.setter
    def rotation_matrix(self, value):
        self._sph.rotation_matrix = value
        self.invalidate()

    @property
    def position_offset(self):
        return self._sph.position_offset

    @position_offset.setter
    def position_offset(self, value):
        self._sph.position_offset = value
        self.invalidate()

    @property
    def scale(self):
        """Viewport half-width in world units."""
        return self._sph.scale

    @scale.setter
    def scale(self, value):
        self._sph.scale = value
        self.invalidate()

    @property
    def quantity_name(self):
        return self.store.quantity_name

    @quantity_name.setter
    def quantity_name(self, value):
        if value == self.store.quantity_name:
            return
        if value is not None:
            try:
                self.data_loader.get_named_quantity(value)
            except Exception as e:
                raise ValueError(
                    f"Unable to get quantity named '{value}'") from e
        self.store.quantity_name = value
        self.invalidate(DrawReason.CHANGE)
        self._colormap.update_parameters({"vmin": None, "vmax": None,
                                          "log": None})
        self._initialize_colormap_and_bar()

    @property
    def averaging(self):
        return self.quantity_name is not None

    # -- view manipulation ---------------------------------------------------------

    def rotate(self, x_angle, y_angle):
        self.rotation_matrix = (x_rotation_matrix(x_angle)
                                @ y_rotation_matrix(y_angle)
                                @ self.rotation_matrix)

    def reset_view(self, rotation_matrix=None, position_offset=None,
                   scale=None):
        if rotation_matrix is None:
            rotation_matrix = np.eye(3)
        if position_offset is None:
            position_offset = -self.data_loader.get_initial_center()
        if scale is None:
            scale = self.data_loader.get_initial_view_width()
        self._sph.rotation_matrix = rotation_matrix
        self._sph.scale = scale
        self._sph.position_offset = position_offset

    def invalidate(self, reason=DrawReason.CHANGE):
        if self._sph is None:
            return
        self._sph.invalidate(reason)
        self.canvas.request_draw(lambda: self.draw(reason))

    def colormap_autorange(self):
        self._colormap.autorange(self._sph.get_image_device())
        self.invalidate(DrawReason.PRESENTATION_CHANGE)

    # -- drawing --------------------------------------------------------------------

    def render_sph(self, draw_reason=DrawReason.CHANGE):
        self._sph.render(draw_reason)

    def draw(self, reason, target=None):
        """Render (if needed) and compose the presentation frame (RGBA,
        uint8 or float16 for ``rgb-hdr``), stored as ``self.last_frame``
        and handed to the canvas.
        ``target``: optional (width, height), defaults to the canvas size.
        An interactive draw that leaves the progression incomplete requests
        a REFINE draw.  A frame made on the renderer's CUDA device (nothing
        composited on the host, ``_compose_presentation``) lies in
        page-locked host memory that the allocator keeps pinned: a caller
        that keeps frames should keep copies (``frame.copy()``)."""
        if self._colormap is None:
            return None
        if target is None:
            width, height = self.canvas.width_physical, self.canvas.height_physical
        else:
            width, height = target
        with signposter.draw():
            if not self._prevent_sph_rendering:
                self.render_sph(reason)
            frame = self._compose_presentation(width, height)
        self.last_frame = frame
        if hasattr(self.canvas, "present_frame"):
            self.canvas.present_frame(frame)
        if (reason != DrawReason.EXPORT and not self._prevent_sph_rendering
                and self._sph.needs_refine()):
            self.invalidate(DrawReason.REFINE)
        return frame

    def _active_overlays(self) -> list:
        """The overlays' composites that the host draws into this frame, in
        order: the colorbar, scale bar and status line where matplotlib
        rasterizes them, the crosshairs and the periodic box."""
        text = text_overlays_available()
        overlays = []
        if (self.show_colorbar and text
                and self._colorbar_overlay() is not None):
            overlays.append(self._colorbar.composite)
        if self.show_scalebar and text:
            overlays.append(self._scalebar.composite)
        if self.crosshairs_visible:
            overlays.append(self._crosshairs.composite)
        if self._periodic_tiling:
            overlays.append(self._cube.composite)
        if self.show_status and text:
            overlays.append(self._status.composite)
        return overlays

    def _compose_presentation(self, width, height) -> np.ndarray:
        """The presented frame.  With no overlay to composite on a uint8
        canvas it is made on the renderer's device and only its uint8
        bytes are read back (into page-locked memory); otherwise the float
        RGBA is read back and ``_composite_overlays`` makes it."""
        overlays = self._active_overlays()
        on_device = self.canvas_format != "rgba16float" and not overlays
        with signposter.use_interval("topsy.present"):
            with signposter.use_interval("topsy.present.colormap"):
                rgba = fit_to_window(
                    self._colormap.to_rgba(self._sph.get_output_image(),
                                           self._sph.last_render_mass_scale),
                    width, height)
                if on_device:
                    rgba = quantize_rgba8(rgba)
                host = rgba.to("cpu", non_blocking=True)
            # the readback is an interactive frame's one barrier: stop the
            # frame clock behind it (this waits for the copy) and report
            # the frame's span to the renderer's deferred LOD and fps timing
            with signposter.use_interval("topsy.present.readback"):
                self._sph.frame_clock.stop()
                self._sph.notify_presentation_barrier()
            with signposter.use_interval("topsy.present.host"):
                if self.show_status:
                    self._update_status_text()
                if on_device:
                    counters["present_device_frames"] += 1
                    return host.numpy()
                counters["present_host_frames"] += 1
                return self._composite_overlays(host.numpy(), overlays)

    def _composite_overlays(self, rgba: np.ndarray, overlays) -> np.ndarray:
        """The presented frame from the read-back RGBA: ``overlays``
        (``_active_overlays``) composited, in the canvas's format."""
        img = rgba.astype(np.float32)
        img[..., 3] = 1.0
        for composite in overlays:
            composite(img)
        if self.canvas_format == "rgba16float":
            return img.astype(np.float16)
        return quantize_rgba8_host(img)

    def display_status(self, text, timeout=0.5):
        self._override_status_text = text
        self._override_status_text_until = time.time() + timeout

    def _update_and_display_status(self, img):
        """The status line's text brought up to date
        (``_update_status_text``) and, where matplotlib imports, drawn
        into ``img``: the reference's one call for both, which
        ``_compose_presentation`` makes as two."""
        self._update_status_text()
        if text_overlays_available():
            self._status.composite(img)

    def _update_status_text(self):
        """The status line: an override of ``display_status`` while it
        lasts, otherwise (every ``STATUS_LINE_UPDATE_INTERVAL`` seconds)
        the fps of the running mean of frame times (CUDA events on the
        card), the downsampling factor and the geometry factor."""
        now = time.time()
        if (hasattr(self, "_override_status_text_until")
                and now < self._override_status_text_until):
            if (self._status.text != self._override_status_text
                    and now - self._last_status_update
                    > config.STATUS_LINE_UPDATE_INTERVAL_RAPID):
                self._status.text = self._override_status_text
                self._last_status_update = now
                self._status.update()
        elif (now - self._last_status_update
                > config.STATUS_LINE_UPDATE_INTERVAL
                and self._sph.last_render_fps):
            self._last_status_update = now
            text = f"${self._sph.last_render_fps:.0f}$ fps"
            factor = np.round(self._sph.last_render_mass_scale, 1)
            if factor > 1.1:
                text += f" /{factor:.1f}ds"
            geom = self._sph.render_progression.get_fraction_volume_selected()
            if geom < 0.9:
                text += f" /{1.0 / geom:.1f}gf"
            self._status.text = text
            self._status.update()

    # -- image access ----------------------------------------------------------------

    def get_sph_image(self) -> np.ndarray:
        """Logical SPH content (no colormap), post-processed on the
        renderer's device."""
        return self._colormap.sph_raw_output_to_content(
            self._sph.get_image_device())

    def get_sph_presentation_image(self) -> np.ndarray:
        """Colormapped SPH image, no overlays, (res, res, 4): uint8, or
        float16 for ``rgb-hdr``."""
        self.render_sph(DrawReason.EXPORT)
        return self._sph_presentation_image()

    def _sph_presentation_image(self) -> np.ndarray:
        """The colormapped image of the renderer's last frame."""
        rgba = self._colormap.to_rgba(self._sph.get_output_image(),
                                      self._sph.last_render_mass_scale)
        rgba = rgba.cpu().numpy()
        if self.canvas_format == "rgba16float":
            return rgba.astype(np.float16)
        return quantize_rgba8_host(rgba)

    def get_presentation_image(self, resolution=(640, 480)) -> np.ndarray:
        """Full presentation frame with overlays at the given size."""
        return self.draw(DrawReason.EXPORT, target=resolution)

    def get_depth_image(self, depth_renderer_reason=DrawReason.CHANGE
                        ) -> np.ndarray:
        """Mass-weighted mean depth (world units) of the current view, NaN
        on empty pixels: the canvas's double-click pick."""
        return self._sph.get_depth_image(depth_renderer_reason)

    @contextmanager
    def prevent_sph_rendering(self):
        """Temporarily block SPH re-rendering for quick screen updates."""
        self._prevent_sph_rendering = True
        try:
            yield
        finally:
            self._prevent_sph_rendering = False

    def save(self, filename="output.pdf"):
        """Render one EXPORT frame and save it: ``.npy`` the raw image
        (``get_sph_image``), ``.tif`` / ``.tiff`` the presentation's RGB as
        float16 (tifffile where installed, else ``hdr_tiff``), any other
        name a matplotlib figure with axes and colorbar."""
        self._sph.render(DrawReason.EXPORT)
        if filename.endswith(".npy"):
            np.save(filename, self.get_sph_image())
            return
        if filename.endswith((".tif", ".tiff")):
            image = self._sph_presentation_image()[..., :3]
            try:
                import tifffile
                tifffile.imwrite(filename, image.astype(np.float16),
                                 photometric="rgb")
            except ImportError:
                from . import hdr_tiff
                hdr_tiff.imwrite(filename, image.astype(np.float16))
            logger.info("Saved %s", filename)
            return
        try:
            import matplotlib.pyplot as p
        except ImportError as e:
            raise ImportError(
                f"saving {filename!r} as a figure needs matplotlib, which is "
                "not installed; save to a .npy file (the raw image) or a "
                ".tif / .tiff file (float16 RGB) instead") from e
        colormap_params = self._colormap.get_parameters()
        fig = p.figure()
        p.clf()
        try:
            p.set_cmap(colormap_params["colormap_name"])
        except ValueError:
            pass
        image = self._sph_presentation_image()
        if image.dtype == np.float16:
            image = np.clip(image.astype(np.float32), 0, 1)
        extent = np.array([-1.0, 1.0, -1.0, 1.0]) * self.scale
        p.imshow(image, extent=extent)
        p.xlabel("$x$/kpc")
        colorbar = self._colorbar_overlay()
        if colorbar is not None:
            p.colorbar(p.cm.ScalarMappable(
                norm=p.Normalize(vmin=self._colormap.get_parameter("vmin"),
                                 vmax=self._colormap.get_parameter("vmax")),
                cmap=colormap_params["colormap_name"]), ax=p.gca()
            ).set_label(colorbar.label)
        p.savefig(filename)
        p.close(fig)
        logger.info("Saved %s", filename)

    def show(self, force=False):
        self.canvas.show()

    def _ipython_display_(self):
        if hasattr(self.canvas, "ipython_display_with_widgets"):
            self.canvas.ipython_display_with_widgets()
        else:
            from IPython.display import display
            display(repr(self))


class Visualizer(SynchronizationMixin, VisualizerBase):
    pass
