"""DDAD (DGP-format) dataset reader: the port's own copy of
``packnet_sfm_tpu/datasets/ddad.py`` (numpy host code; the same samples for
the same files). A self-contained parser of the DGP on-disk scene format,
without the TRI ``dgp`` library:

    <root>/ddad.json                      (scene dataset index; optional)
    <root>/<scene_dir>/scene*.json        (per-scene datum index)
    <root>/<scene_dir>/calibration/*.json (per-sensor intrinsics/extrinsics)
    <root>/<scene_dir>/rgb/<CAMERA>/*.png|jpg
    <root>/<scene_dir>/point_cloud/<LIDAR>/*.npz

- multi-camera samples stacked into leading-axis [N, ...] arrays
  (``stack_cameras``; ``unstack_cameras`` is its inverse, with which the
  train loader transforms a stacked sample camera by camera),
- on-the-fly lidar->depth projection cached next to the cloud as
  ``<cloud>.depth_<camera>.npz`` (the JAX package's name and contents, so
  that a tree cached by one package reads the same in the other),
- temporal context via scene sample ordering,
- context poses relative to the current frame.

A datum is found by its ``channel`` (else ``sensor_name``), compared with
the camera and lidar names as given, case included.
"""

from __future__ import annotations

import glob
import json
import os
import threading
from typing import List, Optional, Sequence

import numpy as np

from packnet_sfm_tpu_torch.datasets.kitti import load_image_u8
from packnet_sfm_tpu_torch.datasets.kitti_utils import invert_pose_numpy


def _quat_to_rot(qw, qx, qy, qz) -> np.ndarray:
    """Unit quaternion -> rotation matrix (DGP pose convention)."""
    n = np.sqrt(qw * qw + qx * qx + qy * qy + qz * qz)
    qw, qx, qy, qz = qw / n, qx / n, qy / n, qz / n
    return np.array([
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy)],
        [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qw * qx)],
        [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * (qx * qx + qy * qy)],
    ])


def _pose_from_json(p: dict) -> np.ndarray:
    """DGP pose json {translation: {x,y,z}, rotation: {qw,qx,qy,qz}} -> [4,4]."""
    T = np.eye(4)
    r = p.get("rotation", {})
    t = p.get("translation", {})
    T[:3, :3] = _quat_to_rot(float(r.get("qw", 1)), float(r.get("qx", 0)),
                             float(r.get("qy", 0)), float(r.get("qz", 0)))
    T[:3, 3] = [float(t.get("x", 0)), float(t.get("y", 0)), float(t.get("z", 0))]
    return T


def project_pointcloud_to_depth(points_lidar: np.ndarray,
                                lidar_to_cam: np.ndarray,
                                K: np.ndarray, h: int, w: int) -> np.ndarray:
    """Project a lidar cloud [N, 3] into a sparse [H, W, 1] depth map; the
    nearest point wins a pixel."""
    pts = points_lidar @ lidar_to_cam[:3, :3].T + lidar_to_cam[:3, 3]
    z = pts[:, 2]
    front = z > 0.1
    pts = pts[front]
    z = z[front]
    u = (K[0, 0] * pts[:, 0] / z + K[0, 2]).astype(np.int32)
    v = (K[1, 1] * pts[:, 1] / z + K[1, 2]).astype(np.int32)
    ok = (u >= 0) & (u < w) & (v >= 0) & (v < h)
    depth = np.zeros((h, w), np.float32)
    # nearest point wins: write far-to-near
    order = np.argsort(-z[ok])
    depth[v[ok][order], u[ok][order]] = z[ok][order]
    return depth[..., None]


class _Scene:
    """One DGP scene: ordered samples of (camera datums, lidar datum)."""

    def __init__(self, scene_dir: str, cameras: Sequence[str], lidar: str):
        self.dir = scene_dir
        jsons = sorted(glob.glob(os.path.join(scene_dir, "scene*.json")))
        if not jsons:
            raise FileNotFoundError(f"no scene json in {scene_dir}")
        with open(jsons[0]) as f:
            scene = json.load(f)
        # datum key -> datum record
        self.datums = {d["key"]: d for d in scene.get("data", [])}
        self.samples = scene.get("samples", [])
        self.cameras = list(cameras)
        self.lidar = lidar
        # calibration: one json keyed by sensor name
        self.calibration = {}
        calib_files = glob.glob(os.path.join(scene_dir, "calibration", "*.json"))
        if calib_files:
            with open(calib_files[0]) as f:
                calib = json.load(f)
            names = calib.get("names", [])
            intrinsics = calib.get("intrinsics", [])
            extrinsics = calib.get("extrinsics", [])
            for i, name in enumerate(names):
                K = np.eye(3)
                if i < len(intrinsics):
                    ic = intrinsics[i]
                    K = np.array([[float(ic.get("fx", 1)), 0, float(ic.get("cx", 0))],
                                  [0, float(ic.get("fy", 1)), float(ic.get("cy", 0))],
                                  [0, 0, 1]])
                E = (_pose_from_json(extrinsics[i])
                     if i < len(extrinsics) else np.eye(4))
                self.calibration[name] = (K.astype(np.float32), E.astype(np.float32))

    def __len__(self):
        return len(self.samples)

    def datum_for(self, sample_idx: int, sensor: str) -> Optional[dict]:
        for key in self.samples[sample_idx].get("datum_keys", []):
            d = self.datums.get(key)
            if d is None:
                continue
            body = d.get("datum", {})
            rec = body.get("image") or body.get("point_cloud")
            if rec and rec.get("channel", rec.get("sensor_name")) == sensor:
                return d
        return None


class DDADDataset:
    """Multi-camera DDAD reader emitting stacked [N_cam, ...] samples."""

    def __init__(self, path: str, split: str = "train",
                 cameras: Optional[Sequence[str]] = None,
                 depth_type: Optional[str] = None,
                 input_depth_type: Optional[str] = None,
                 with_pose: bool = False,
                 back_context: int = 0, forward_context: int = 0,
                 data_transform=None, train: bool = True, **kwargs):
        self.path = path
        self.cameras = list(cameras or ["CAMERA_01"])
        self.lidar = depth_type or "LIDAR"
        self.with_depth = bool(depth_type)
        # the lidar whose projection is the network's input depth (PackNet-
        # SAN); the JAX package's reader takes this argument and drops it
        self.input_lidar = input_depth_type or None
        self.with_pose = with_pose
        self.bwd, self.fwd = back_context, forward_context
        self.has_context = back_context + forward_context > 0
        self.data_transform = data_transform

        scene_dirs = sorted(
            d for d in glob.glob(os.path.join(path, "*"))
            if os.path.isdir(d) and glob.glob(os.path.join(d, "scene*.json")))
        self.scenes: List[_Scene] = [
            _Scene(d, self.cameras, self.lidar) for d in scene_dirs]
        # index: (scene_idx, sample_idx) with context bounds respected
        self.index = []
        for si, scene in enumerate(self.scenes):
            for k in range(self.bwd, len(scene) - self.fwd):
                self.index.append((si, k))

    def __len__(self):
        return len(self.index)

    # ------------------------------------------------------------- helpers

    def _image_record(self, scene: _Scene, sample_idx: int, cam: str):
        d = scene.datum_for(sample_idx, cam)
        if d is None:
            raise KeyError(f"no datum for {cam} in sample {sample_idx}")
        img = d["datum"]["image"]
        return img

    def _load_rgb(self, scene: _Scene, sample_idx: int, cam: str) -> np.ndarray:
        rec = self._image_record(scene, sample_idx, cam)
        return load_image_u8(os.path.join(scene.dir, rec["filename"]))

    def _pose(self, scene: _Scene, sample_idx: int, cam: str) -> np.ndarray:
        rec = self._image_record(scene, sample_idx, cam)
        return _pose_from_json(rec.get("pose", {})).astype(np.float32)

    def _depth(self, scene: _Scene, sample_idx: int, cam: str,
               shape, lidar: Optional[str] = None) -> np.ndarray:
        """Lidar depth projected into the camera, cached next to the cloud;
        of ``lidar``, else the ground truth's sensor."""
        lidar = lidar or self.lidar
        d = scene.datum_for(sample_idx, lidar)
        if d is None:
            return np.zeros(shape[:2] + (1,), np.float32)
        pc_rec = d["datum"]["point_cloud"]
        pc_file = os.path.join(scene.dir, pc_rec["filename"])
        cache = pc_file.replace(".npz", f".depth_{cam}.npz")
        if os.path.exists(cache):
            return np.load(cache)["depth"]
        cloud = np.load(pc_file)
        points = cloud[cloud.files[0]][:, :3]
        K, cam_extr = scene.calibration.get(cam, (np.eye(3, dtype=np.float32),
                                                  np.eye(4, dtype=np.float32)))
        _, lidar_extr = scene.calibration.get(lidar, (None, np.eye(4, dtype=np.float32)))
        # sensor extrinsics are sensor->vehicle; lidar->cam = inv(cam) @ lidar
        lidar_to_cam = invert_pose_numpy(cam_extr) @ lidar_extr
        depth = project_pointcloud_to_depth(
            points, lidar_to_cam, K, shape[0], shape[1])
        # written whole, then renamed: a loader thread reading the same
        # sample (a repeated split) never sees a partial file
        tmp = f"{cache[:-4]}.{os.getpid()}_{threading.get_ident()}.tmp.npz"
        try:
            np.savez_compressed(tmp, depth=depth)
            os.replace(tmp, cache)
        except OSError:
            pass
        return depth

    # ------------------------------------------------------------- samples

    def _one_camera(self, scene: _Scene, k: int, cam: str, idx: int) -> dict:
        rgb = self._load_rgb(scene, k, cam)
        K, _ = scene.calibration.get(cam, (np.eye(3, dtype=np.float32), None))
        sample = {
            "idx": idx,
            "filename": f"{os.path.basename(scene.dir)}_{k:06d}_{cam}",
            "rgb": rgb,
            "intrinsics": K.astype(np.float32),
        }
        if self.with_depth:
            sample["depth"] = self._depth(scene, k, cam, rgb.shape)
        if self.input_lidar:
            sample["input_depth"] = self._depth(scene, k, cam, rgb.shape, self.input_lidar)
        if self.with_pose:
            sample["pose"] = self._pose(scene, k, cam)
        if self.has_context:
            ctx_idxs = [k - d for d in range(self.bwd, 0, -1)] + \
                [k + d for d in range(1, self.fwd + 1)]
            sample["rgb_context"] = [self._load_rgb(scene, c, cam)
                                     for c in ctx_idxs]
            if self.with_pose:
                cur = sample["pose"]
                sample["pose_context"] = [
                    (invert_pose_numpy(self._pose(scene, c, cam)) @ cur
                     ).astype(np.float32)
                    for c in ctx_idxs]
        if self.data_transform is not None:
            sample = self.data_transform(sample, idx=idx)
        else:
            from packnet_sfm_tpu_torch.datasets.augmentations import ensure_float_sample
            sample = ensure_float_sample(sample)
        return sample

    def __getitem__(self, idx: int) -> dict:
        si, k = self.index[idx]
        scene = self.scenes[si]
        per_cam = [self._one_camera(scene, k, cam, idx) for cam in self.cameras]
        if len(per_cam) == 1:
            return per_cam[0]
        return stack_cameras(per_cam)


def stack_cameras(per_cam: Sequence[dict]) -> dict:
    """One sample of several cameras, each value stacked on a new leading
    axis [N, ...] (context lists element-wise); 'idx' and 'filename' are the
    first camera's."""
    stacked = {"idx": per_cam[0]["idx"], "filename": per_cam[0]["filename"]}
    for key in per_cam[0]:
        if key in ("idx", "filename"):
            continue
        v = per_cam[0][key]
        if isinstance(v, list):
            stacked[key] = [np.stack([s[key][i] for s in per_cam])
                            for i in range(len(v))]
        else:
            stacked[key] = np.stack([s[key] for s in per_cam])
    return stacked


def unstack_cameras(sample: dict) -> List[dict]:
    """The per-camera samples of a stacked one (``stack_cameras``' inverse up
    to the cameras' filenames, which stacking drops)."""
    n = len(sample["rgb"])
    return [{k: v if k in ("idx", "filename") else
             [x[c] for x in v] if isinstance(v, list) else v[c]
             for k, v in sample.items()} for c in range(n)]
