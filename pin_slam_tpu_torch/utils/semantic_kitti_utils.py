"""SemanticKITTI label mapping and color map. The port's own copy of
`pin_slam_tpu/utils/semantic_kitti_utils.py` (numpy only).

Rebuilds reference utils/semantic_kitti_utils.py:43-131. The 34->20 class
learning map, names, and colors are the standard SemanticKITTI API
configuration (public dataset metadata).
"""

import numpy as np

# raw label -> learning label (0 = unlabeled); standard semantic-kitti map
LEARNING_MAP = {
    0: 0, 1: 0, 10: 1, 11: 2, 13: 5, 15: 3, 16: 5, 18: 4, 20: 5,
    30: 6, 31: 7, 32: 8, 40: 9, 44: 10, 48: 11, 49: 12, 50: 13,
    51: 14, 52: 0, 60: 9, 70: 15, 71: 16, 72: 17, 80: 18, 81: 19,
    99: 0, 252: 1, 253: 7, 254: 6, 255: 8, 256: 5, 257: 5, 258: 4, 259: 5,
}

LABELS = {
    0: "unlabeled", 1: "car", 2: "bicycle", 3: "motorcycle", 4: "truck",
    5: "other-vehicle", 6: "person", 7: "bicyclist", 8: "motorcyclist",
    9: "road", 10: "parking", 11: "sidewalk", 12: "other-ground",
    13: "building", 14: "fence", 15: "vegetation", 16: "trunk",
    17: "terrain", 18: "pole", 19: "traffic-sign",
}

# moving-object learning ids (filtered when filter_moving_object is on,
# reference: dataset/slam_dataset.py filter_sem_kitti)
MOVING_LEARNING_IDS = {1, 4, 5, 6, 7, 8}

COLOR_MAP = {  # bgr like the dataset api; converted below
    0: [0, 0, 0], 1: [245, 150, 100], 2: [245, 230, 100], 3: [150, 60, 30],
    4: [180, 30, 80], 5: [255, 0, 0], 6: [30, 30, 255], 7: [200, 40, 255],
    8: [90, 30, 150], 9: [255, 0, 255], 10: [255, 150, 255],
    11: [75, 0, 75], 12: [75, 0, 175], 13: [0, 200, 255], 14: [50, 120, 255],
    15: [0, 175, 0], 16: [0, 60, 135], 17: [80, 240, 150],
    18: [150, 240, 255], 19: [0, 0, 255],
}

_MAP_ARRAY = np.zeros(260, np.int32)
for k, v in LEARNING_MAP.items():
    _MAP_ARRAY[k] = v


def sem_map_function(labels: np.ndarray) -> np.ndarray:
    """Vectorized raw->learning label map (reference :120-131)."""
    return _MAP_ARRAY[np.clip(np.asarray(labels, np.int64), 0, 259)]


def sem_kitti_color(learning_labels: np.ndarray) -> np.ndarray:
    """Learning labels -> rgb [0,1]."""
    out = np.zeros((len(learning_labels), 3))
    for i, l in enumerate(np.asarray(learning_labels, np.int64)):
        b, g, r = COLOR_MAP.get(int(l), [0, 0, 0])
        out[i] = [r / 255.0, g / 255.0, b / 255.0]
    return out


def filter_moving_mask(learning_labels: np.ndarray) -> np.ndarray:
    """Keep-mask over points: True where the class is static (reference
    filter_sem_kitti, dataset/slam_dataset.py:1273+)."""
    return ~np.isin(learning_labels, list(MOVING_LEARNING_IDS))


def filter_moving(points: np.ndarray, learning_labels: np.ndarray):
    """Drop moving-class points (reference filter_sem_kitti,
    dataset/slam_dataset.py:1273+)."""
    keep = filter_moving_mask(learning_labels)
    return points[keep], learning_labels[keep]


def read_semantic_point_label(bin_path: str, label_path: str):
    """(reference: dataset/slam_dataset.py:1063-1092)"""
    points = np.fromfile(bin_path, dtype=np.float32).reshape(-1, 4)
    labels = np.fromfile(label_path, dtype=np.uint32).reshape(-1)
    labels = labels & 0xFFFF
    labels_reduced = sem_map_function(labels)
    return points, labels.astype(np.int32), labels_reduced
