"""Tunables of the renderer, as the port reads them.

A pinned copy of the constants of ``topsy_tpu/config.py`` that the port
uses (``tests/test_torch_copies.py`` holds each equal to the original).
Behavioural constants mirror the original viewer; the splat constants
(pyramid depth, windows, spill budgets, launch caps) shape the kernels'
inputs and so are part of the render's semantics.
"""

# ---------------------------------------------------------------- display ---
DEFAULT_RESOLUTION = 1024
DEFAULT_COLORMAP = "twilight_shifted"

DEFAULT_SCALE = 200.0  # viewport half-width in kpc

TARGET_FPS = 30  # adaptive LOD keeps this
INITIAL_PARTICLES_TO_RENDER = 1e5
STATUS_LINE_UPDATE_INTERVAL = 0.2  # seconds
STATUS_LINE_UPDATE_INTERVAL_RAPID = 0.05

GLIDE_TIME = 0.3  # seconds after double click to reach destination

COLORBAR_ASPECT_RATIO = 0.15
COLORMAP_NUM_SAMPLES = 1000

TEST_DATA_NUM_PARTICLES_DEFAULT = int(1e6)

# ------------------------------------------------------------ particle LOD --
MAX_PARTICLES_PER_BUFFER = 2**27
# kept for API parity with the reference buffer splitting; nothing reads it.

MAX_PARTICLES_PER_EXPORT_RENDERCALL = 2**25
# EXPORT renders are chunked into calls of at most this many particles.

DEFAULT_CELLS_NSIDE = 16
# spatial grid of the array and pynbody loaders' geometric culling

CELL_LAYOUT_FRACTIONAL_PADDING = 1e-5

# fraction of the frame budget below which no new block is attempted
FRAME_BUDGET_CUTOFF_FRACTION = 0.4

JUPYTER_UI_LAG = 0.05

PROJECTED_DENSITY_NAME = "Projected density"  # the controllers' density entry

MAX_SURFACE_SMOOTH_PIXELS = 100

# ---------------------------------------------------------------- splatting --
SPLAT_KERNEL_RANK = 2
# rank of the separable (eigen) decomposition of the projected SPH kernel

SPLAT_POLY_DEGREE = 6
# degree (in t^2) of the polynomial fit to each kernel eigen-profile,
# constrained to vanish at the support edge (t^2 = 4)

SPLAT_MAX_HALF_SIZE_PX = 3.5
# pyramid level is chosen so that the smoothing length in level pixels is at
# most this; footprint (radius 2h <= 7px) then fits in a 16px window.

SPLAT_MIN_HALF_SIZE_PX = 0.71
# smoothing lengths are clamped up to this many (level) pixels

SPLAT_WINDOW = 16
# side of the square footprint window used by the scatter path

SPLAT_PYRAMID_LEVELS = 7
# levels 0..6 -> level L resolution = resolution / 2^L (coarsest 16px).

PYRAMID_COLLAPSE_FILTER = "spline"
# reconstruction filter for the density pyramid collapse

SPLAT_BAND_ROWS = 8
# rows per band; group output windows are aligned to this

SPLAT_ATLAS_PAD = 64
# padding rows between pyramid levels in the atlas canvas

SPLAT_ATLAS_COL_PAD = 16
# padding cols on either side of the atlas (edge-clipping margin).

SPLAT_SPILL_GROUP_CAP = 128
# capacity (in main-pass groups) of the spill tiers for particles that do
# not fit their group's accumulation window

SPLAT_FEED_LAUNCH_CAP = 1 << 24
# per-launch particle cap of the presorted additive EXPORT path

INTERACTIVE_USE_PRESORTED = True
# column slices of the presorted (groups x 512) matrix are the LOD subsets
# (progression.RenderProgressionColumns); the surface renderer activates
# the columns progression even for EXPORT

COLUMN_MIP_FLOOR_TARGET = 1 << 20
# decimation-mip tiers (ops/morton_device.build_mip_layout) are chained
# until the smallest interactive column block of the deepest tier holds at
# most this many particles; interactive CHANGE frames render whole tiers

COLUMN_MIP_MAX_TIERS = 2
# upper bound on chained decimation tiers

SPLAT_COLUMNS_GROUP_CAP = 1 << 15
# max particle groups per column launch; larger column renders split into
# group-axis pieces combined by sum / max-composite

AUTORANGE_PERCENTILES = (1.0, 99.9)

GPU_TIMING_SMOOTH_WINDOW = 10  # frames of running-mean for fps display
