"""Copy of ``recmv_tpu/config/constants.py``, kept byte-for-byte apart from this note and
its imports: the port runs where JAX is absent, and importing any
``recmv_tpu`` module imports JAX.

Garment taxonomy and framework-wide constant tables.

Parity with the reference's ``utils/constant.py:92-263``: subject → garment
pieces (TEMPLATE_GARMENT), subject → feature-curve names (FL_INFOS),
garment → extracted curves (FL_EXTRACT / GARMENT_FL_MATCH), template
boundary color codes (GARMENT_COLOR_MAP), ATR human-parsing label groups
(ATR_PARSING), z-buffer visibility thresholds, initial curve scales, and
smoothing/rendering presets. Values are plain Python / numpy — device
arrays are created at point of use.
"""

import numpy as np

FL_CONSTANT = {
    0: "neckline",
    1: "right_cuff",
    2: "left_cuff",
    3: "upper_waist",
    4: "lower_waist",
    5: "right_knee",
    6: "left_knee",
    7: "skirt_bottom",
}
FL_NAME = list(FL_CONSTANT.values())

FL_FLIP = {"right_cuff": "left_cuff", "right_knee": "left_knee"}
FL_CLASSES_FLIP = {2: 3, 6: 7}

RAY_DIRS = np.array([[0.0, 0.0, 1.0]], dtype=np.float32)
Z_RAY = np.array([[0.0, 0.0, 1.0]], dtype=np.float32)
FL_IDX = ["neck", "right_cuff", "left_cuff", "bottom_curve"]
TMP_FL_IDX = ["neck_line", "right_cuff", "left_cuff", "upper_waist"]

SNUG_MAP = {
    "top00": "bottom_curve",
    "top01": "neck",
    "top02": "right_cuff",
    "top03": "left_cuff",
}
RP4D_MAP = {0: "neck", 1: "right_cuff", 2: "left_cuff", 3: "bottom_curve"}

# Template initialization: garment type → boundary curves used for matching.
GARMENT_FL_MATCH = {
    "long_sleeve_upper": ["neck", "left_cuff", "right_cuff", "upper_bottom"],
    "long_pants": ["left_pant", "right_pant", "upper_bottom"],
    "short_pants": ["left_pant", "right_pant", "upper_bottom"],
    "short_sleeve_upper": ["neck", "left_cuff", "right_cuff", "upper_bottom"],
    "dress": ["neck", "left_cuff", "right_cuff", "bottom_curve"],
    "skirt": ["upper_bottom", "bottom_curve"],
    "tube": ["neck", "bottom_curve"],
    "no_sleeve_upper": ["neck", "left_cuff", "right_cuff", "bottom_curve"],
    "upper_tube": ["neck", "upper_bottom"],
}

# Feature-line representation: garment type → curves that get explicit
# Intersect_Free_Curve parameterizations.
FL_EXTRACT = {
    "long_sleeve_upper": ["neck", "left_cuff", "right_cuff", "upper_bottom"],
    "dress": ["neck", "left_cuff", "right_cuff", "bottom_curve"],
    "long_pants": ["left_pant", "right_pant"],
    "short_pants": ["left_pant", "right_pant"],
    "short_sleeve_upper": ["neck", "left_cuff", "right_cuff", "upper_bottom"],
    "tube": ["neck", "bottom_curve"],
    "skirt": ["bottom_curve"],
    "no_sleeve_upper": ["neck", "left_cuff", "right_cuff", "bottom_curve"],
    "upper_tube": ["neck", "upper_bottom"],
}

WHOLE_BODY = ["long_pants", "long_sleeve_upper"]

TEMPLATE_GARMENT_INDEX = {
    0: "long_pants",
    1: "long_sleeve_upper",
    2: "no_sleeve_upper",
    3: "short_sleeve_open_upper",
    4: "skirt",
    5: "long_sleeve_open_upper",
    6: "no_sleeve_open_upper",
    7: "short_pants",
    8: "short_sleeve_upper",
}

# Subject name → list of garment pieces jointly reconstructed.
TEMPLATE_GARMENT = {
    "dance": ["short_sleeve_upper"],
    "anran": ["short_sleeve_upper", "skirt"],
    "xiaolin": ["no_sleeve_upper"],
    "leyang": ["short_sleeve_upper"],
    "tingting": ["short_sleeve_upper"],
    # synthetic
    "female_outfit1": ["no_sleeve_upper"],
    "female_outfit3": ["tube"],
    "male_outfit1": ["long_sleeve_upper", "short_pants"],
    "male_outfit2": ["long_sleeve_upper", "long_pants"],
    # female large pose
    "anran_run": ["short_sleeve_upper", "skirt"],
    "anran_tic": ["short_sleeve_upper", "skirt"],
    "leyang_jump": ["dress"],
    "leyang_steps": ["dress"],
    "anran_dance": ["short_sleeve_upper", "skirt"],
    "lingteng_dance": ["short_sleeve_upper", "short_pants"],
    # built-in synthetic fixture scenes (recmv_tpu.data.synthetic)
    "synthetic-tube": ["tube"],
    "synthetic-two": ["upper_tube", "skirt"],   # two-piece, shared waist
    "synthetic-skirt": ["skirt"],               # loose A-line, diffused skinning
    # people_snapshot_public
    "female-1-casual": ["short_sleeve_upper", "long_pants"],
    "female-3-casual": ["long_sleeve_upper", "long_pants"],
    "female-3-sport": ["long_sleeve_upper", "long_pants"],
    "female-4-casual": ["long_sleeve_upper", "long_pants"],
    "female-4-sport": ["short_sleeve_upper", "short_pants"],
    "female-6-plaza": ["long_sleeve_upper", "long_pants"],
    "female-7-plaza": ["long_sleeve_upper", "long_pants"],
    "male-1-casual": ["short_sleeve_upper", "long_pants"],
    "male-1-plaza": ["short_sleeve_upper", "long_pants"],
    "male-1-sport": ["short_sleeve_upper", "short_pants"],
    "male-2-casual": ["long_sleeve_upper", "long_pants"],
    "male-2-outdoor": ["long_sleeve_upper", "long_pants"],
    "male-4-casual": ["long_sleeve_upper", "long_pants"],
    "male-5-outdoor": ["long_sleeve_upper", "short_pants"],
    "male-9-plaza": ["long_sleeve_upper", "long_pants"],
}

_PS_FL = ["neck", "left_cuff", "right_cuff", "upper_bottom", "left_pant", "right_pant"]
# Subject name → annotated 2D feature-line names.
FL_INFOS = {
    "dance": ["short_sleeve_upper"],
    "anran": ["neck", "left_cuff", "right_cuff", "upper_bottom", "bottom_curve"],
    "xiaolin": ["neck", "left_cuff", "right_cuff", "bottom_curve"],
    "leyang": ["short_sleeve_upper"],
    "tingting": ["short_sleeve_upper"],
    "female_outfit1": ["neck", "left_cuff", "right_cuff", "bottom_curve"],
    "female_outfit3": ["neck", "bottom_curve"],
    "male_outfit1": _PS_FL,
    "male_outfit2": _PS_FL,
    "anran_run": ["neck", "left_cuff", "right_cuff", "upper_bottom", "bottom_curve"],
    "anran_tic": ["neck", "left_cuff", "right_cuff", "upper_bottom", "bottom_curve"],
    "leyang_jump": ["neck", "left_cuff", "right_cuff", "bottom_curve"],
    "leyang_steps": ["neck", "left_cuff", "right_cuff", "bottom_curve"],
    "anran_dance": ["neck", "left_cuff", "right_cuff", "upper_bottom", "bottom_curve"],
    "lingteng_dance": _PS_FL,
    "synthetic-tube": ["neck", "bottom_curve"],
    "synthetic-two": ["neck", "upper_bottom", "bottom_curve"],
    "synthetic-skirt": ["upper_bottom", "bottom_curve"],
    "female-3-casual": _PS_FL,
    "female-3-sport": _PS_FL,
    "female-4-casual": _PS_FL,
    "female-4-sport": _PS_FL,
    "female-6-plaza": _PS_FL,
    "female-7-plaza": _PS_FL,
    "male-1-casual": _PS_FL,
    "male-1-sport": _PS_FL,
    "male-2-casual": _PS_FL,
    "male-2-outdoor": _PS_FL,
    "male-4-casual": _PS_FL,
    "male-5-outdoor": _PS_FL,
    "male-9-plaza": _PS_FL,
}

PANTS_GARMENT = [
    "long_pants",
    "no_sleeve_upper",
    "long_skirt",
    "short_pants",
    "long_sleeve_dress",
    "short_sleeve_dress",
    "long_sleeve_upper",
    "short_sleeve_upper",
    "no_sleeve_dress",
    "skirt",
]

_UPPER_COLORS = dict(
    back_ground=[125, 125, 125],
    left_cuff=[131, 149, 69],
    right_cuff=[185, 82, 185],
    upper_bottom=[211, 200, 42],
    neck=[250, 15, 16],
)
_OPEN_COLORS = dict(
    back_ground=[125, 125, 125],
    left_cuff=[131, 149, 69],
    right_cuff=[185, 82, 185],
    bottom_curve=[211, 200, 42],
    neck=[250, 15, 16],
)
_PANTS_COLORS = dict(
    back_ground=[125, 125, 125],
    left_pant=[42, 211, 141],
    right_pant=[67, 42, 211],
    upper_bottom=[211, 200, 42],
)
# Vertex-color codes that mark boundary loops on DeepFashion3D templates.
GARMENT_COLOR_MAP = {
    "short_sleeve_upper": _UPPER_COLORS,
    "long_pants": _PANTS_COLORS,
    "short_pants": _PANTS_COLORS,
    "long_sleeve_upper": _UPPER_COLORS,
    "skirt": dict(back_ground=[125, 125, 125], bottom_curve=[155, 126, 151], upper_bottom=[211, 200, 42]),
    "tube": dict(back_ground=[125, 125, 125], bottom_curve=[155, 126, 151], neck=[211, 200, 42]),
    "upper_tube": dict(back_ground=[125, 125, 125], upper_bottom=[211, 200, 42], neck=[250, 15, 16]),
    "no_sleeve_upper": _OPEN_COLORS,
    "dress": _OPEN_COLORS,
}

# ATR parsing label groups (18-class ATR schema).
ATR_PARSING = {
    "upper": [1, 2, 3, 4, 11, 16, 17, 14, 15],
    "bottom": [5, 6, 8],
    "upper_bottom": [1, 2, 3, 4, 5, 7, 8, 11, 16, 17, 14, 15, 6],
}

FL_COLOR = {
    "neck": (0, 0, 255),
    "right_cuff": (0, 255, 0),
    "left_cuff": (255, 0, 0),
    "left_pant": (127, 127, 0),
    "right_pant": (0, 127, 127),
    "upper_bottom": (127, 0, 127),
    "bottom_curve": (0, 127, 127),
}

# Curve-point visibility: max allowed z gap vs the body z-buffer.
ZBUF_THRESHOLD = {
    "neck": 0.1,
    "right_cuff": 0.05,
    "left_cuff": 0.05,
    "left_pant": 0.05,
    "right_pant": 0.05,
    "upper_bottom": 0.08,
    "bottom_curve": 0.1,
}

CURVE_AWARE = {
    "female_outfit1": "bottom_curve",
    "female_outfit3": "bottom_curve",
    "anran_dance": "bottom_curve",
}

# Initial radial scale priors for curve rigid+scale initialization.
INI_FL_SCALE = {
    "neck": 1.5,
    "right_cuff": 1.5,
    "left_cuff": 1.5,
    "left_pant": 1.5,
    "right_pant": 1.5,
    "upper_bottom": 2.0,
    "bottom_curve": 2.0,
}

SMOOTH_TRANS = {
    "anran": [[116, 150], [269, 309]],
    "lingteng_dance": [[34, 41]],
    "xiaolin": [[]],
    "anran_tic": [[]],
    "anran_run": [[]],
    "leyang_jump": [[]],
}

RENDER_COLORS = {
    "anran": [[255, 255, 0], [170, 170, 255]],
    "lingteng_dance": [[170, 170, 127], [72, 152, 170]],
    "xiaolin": [[193, 210, 240]],
    "anran_tic": [[255, 99, 128], [193, 210, 240]],
    "anran_run": [[255, 99, 128], [193, 210, 240]],
    "leyang_jump": [[193, 210, 240]],
    "female-3-casual": [[255, 99, 128], [193, 210, 240]],
}
