"""KITTI raw-format helpers: calibration parsing and OXTS GPS/IMU poses.

The port's own copy of ``packnet_sfm_tpu/datasets/kitti_utils.py`` (numpy;
the same results for the same files): reads the standard KITTI calib txt
files and converts OXTS packets to SE(3) poses via the Mercator projection
(standard formulas from the KITTI devkit).
"""

from __future__ import annotations

import numpy as np

EARTH_RADIUS = 6378137.0  # meters


def read_calib_file(path: str) -> dict:
    """Parse a KITTI calibration file into {key: np.array | str}."""
    data = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            key, value = line.split(":", 1)
            value = value.strip()
            try:
                data[key] = np.array([float(x) for x in value.split()])
            except ValueError:
                data[key] = value
    return data


def rotation_from_rpy(roll: float, pitch: float, yaw: float) -> np.ndarray:
    """R = Rz(yaw) @ Ry(pitch) @ Rx(roll) (KITTI devkit convention)."""
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def pose_from_oxts_packet(packet: np.ndarray, scale: float):
    """OXTS packet -> (R [3,3], t [3]) in the Mercator-projected world frame.

    packet layout: lat, lon, alt, roll, pitch, yaw, ... (KITTI oxts txt).
    ``scale`` = cos(lat0 * pi / 180) fixes the Mercator scale at the sequence
    origin (parity: reference kitti_dataset_utils.py:138).
    """
    lat, lon, alt = packet[0], packet[1], packet[2]
    roll, pitch, yaw = packet[3], packet[4], packet[5]
    tx = scale * lon * np.pi * EARTH_RADIUS / 180.0
    ty = scale * EARTH_RADIUS * np.log(np.tan((90.0 + lat) * np.pi / 360.0))
    t = np.array([tx, ty, alt])
    R = rotation_from_rpy(roll, pitch, yaw)
    return R, t


def transform_from_rot_trans(R, t) -> np.ndarray:
    """(R, t) -> [4,4] homogeneous transform (reference :88)."""
    T = np.eye(4)
    T[:3, :3] = np.asarray(R).reshape(3, 3)
    T[:3, 3] = np.asarray(t).reshape(3)
    return T


def invert_pose_numpy(T: np.ndarray) -> np.ndarray:
    """SE(3) inverse (reference geometry/pose_utils.py:64)."""
    out = np.eye(4)
    R, t = T[:3, :3], T[:3, 3]
    out[:3, :3] = R.T
    out[:3, 3] = -R.T @ t
    return out
