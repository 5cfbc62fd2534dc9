"""KITTI raw dataset reader: the port's own copy of
``packnet_sfm_tpu/datasets/kitti.py`` (numpy host code; the same samples for
the same files): split-file driven sample list, temporal context discovery
with strides and bounds checks, calib caching, velodyne-npz /
groundtruth-png depth loading, OXTS GPS/IMU pose chains mapped into the
camera frame, and the sample dict schema {idx, filename, rgb, intrinsics,
pose?, depth?, input_depth?, rgb_context?, pose_context?}.

Emits numpy NHWC; images are decoded through the native library
(``packnet_sfm_tpu_torch/native``) where it builds, else through Pillow,
which is imported where it is used. Device transfer happens in the train
and eval steps.
"""

from __future__ import annotations

import glob
import os
from typing import Optional, Sequence

import numpy as np

from packnet_sfm_tpu_torch.datasets.kitti_utils import (
    invert_pose_numpy,
    pose_from_oxts_packet,
    read_calib_file,
    transform_from_rot_trans,
)

IMAGE_FOLDER = {"left": "image_02", "right": "image_03"}
CALIB_FILE = {
    "cam2cam": "calib_cam_to_cam.txt",
    "velo2cam": "calib_velo_to_cam.txt",
    "imu2velo": "calib_imu_to_velo.txt",
}
PNG_DEPTH_DATASETS = ("groundtruth",)
OXTS_POSE_DATA = "oxts"


def load_image_u8(path: str) -> np.ndarray:
    """RGB image as uint8 [H, W, 3].

    Decodes through the native library where it is available (the loader's
    hot path), else through Pillow; ``native.decoder()`` says which. Images
    stay uint8 through crop and resize and become float32 [0, 1] only at
    the end of the transform, on the small resized image."""
    if path.lower().endswith((".jpg", ".jpeg", ".png")):
        from packnet_sfm_tpu_torch.native import decode_image

        arr = decode_image(path)
        if arr is not None:
            return arr
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def load_image(path: str) -> np.ndarray:
    """RGB image as float32 [H, W, 3] in [0, 1]."""
    return load_image_u8(path).astype(np.float32) / 255.0


def read_npz_depth(file: str, depth_type: str) -> np.ndarray:
    depth = np.load(file)[depth_type + "_depth"].astype(np.float32)
    return depth[..., None]


def read_png_depth(file: str) -> np.ndarray:
    """KITTI png depth: value/256, 0 -> -1 invalid marker."""
    from PIL import Image

    with Image.open(file) as im:
        depth_png = np.asarray(im, dtype=np.int64)
    if depth_png.max() <= 255:
        raise ValueError(f"{file}: not a 16-bit KITTI depth png (largest value "
                         f"{depth_png.max()})")
    depth = depth_png.astype(np.float32) / 256.0
    depth[depth_png == 0] = -1.0
    return depth[..., None]


class KITTIDataset:
    """Split-file driven KITTI reader (see module docstring)."""

    def __init__(
        self,
        root_dir: str,
        file_list: str,
        train: bool = True,
        data_transform=None,
        depth_type: Optional[str] = None,
        input_depth_type: Optional[str] = None,
        with_pose: bool = False,
        back_context: int = 0,
        forward_context: int = 0,
        strides: Sequence[int] = (1,),
    ):
        assert back_context >= 0 and forward_context >= 0
        self.root_dir = root_dir
        self.split = os.path.basename(file_list).split(".")[0]
        self.train = train
        self.data_transform = data_transform
        self.backward_context = back_context
        self.forward_context = forward_context
        self.with_context = back_context != 0 or forward_context != 0
        self.depth_type = depth_type or None
        self.with_depth = bool(depth_type)
        self.input_depth_type = input_depth_type or None
        self.with_input_depth = bool(input_depth_type)
        self.with_pose = with_pose

        self._folder_size_cache: dict = {}
        self._calib_cache: dict = {}
        self._oxts_cache: dict = {}
        self._imu2cam_cache: dict = {}
        self._pose_cache: dict = {}

        with open(file_list) as f:
            lines = [l.split()[0] for l in f if l.strip()]

        self.paths = []
        for rel in lines:
            path = os.path.join(root_dir, rel)
            ok = True
            if ok and self.with_input_depth:
                df = self._depth_file(path, self.input_depth_type)
                ok = df is not None and os.path.exists(df)
            if ok and self.with_depth:
                df = self._depth_file(path, self.depth_type)
                ok = df is not None and os.path.exists(df)
            if ok:
                self.paths.append(path)

        self.backward_context_idxs = []
        self.forward_context_idxs = []
        if self.with_context:
            kept = []
            for stride in strides:
                for path in self.paths:
                    back, fwd = self._context_indices(
                        path, back_context, forward_context, stride)
                    if back is not None and fwd is not None:
                        kept.append(path)
                        self.backward_context_idxs.append(back[::-1])
                        self.forward_context_idxs.append(fwd)
            self.paths = kept

    # ---------------------------------------------------------------- files

    def sample_shape(self, idx: int):
        """(H, W) of this sample's native image/gt depth — read from the
        image header only (no decode). Lets the eval DataLoader bucket
        mixed-size sequences (KITTI eigen_test mixes 1242/1241/1226 widths)
        into homogeneous batches so eval batch>1 works at native gt
        resolution."""
        cache = getattr(self, "_shape_cache", None)
        if cache is None:
            cache = self._shape_cache = {}
        if idx not in cache:
            from PIL import Image

            with Image.open(self.paths[idx]) as im:
                w, h = im.size  # lazy: header only
            cache[idx] = (h, w)
        return cache[idx]

    @staticmethod
    def _neighbor_file(idx: int, file: str) -> str:
        base, ext = os.path.splitext(os.path.basename(file))
        return os.path.join(os.path.dirname(file), str(idx).zfill(len(base)) + ext)

    @staticmethod
    def _parent_folder(image_file: str) -> str:
        return os.path.abspath(os.path.join(image_file, "../../../.."))

    @staticmethod
    def _depth_file(image_file: str, depth_type: str) -> Optional[str]:
        for cam in ("left", "right"):
            if IMAGE_FOLDER[cam] in image_file:
                out = image_file.replace(
                    IMAGE_FOLDER[cam] + "/data",
                    f"proj_depth/{depth_type}/{IMAGE_FOLDER[cam]}")
                if depth_type not in PNG_DEPTH_DATASETS:
                    out = out.replace("png", "npz")
                return out
        return None

    def _read_depth(self, depth_file: str) -> np.ndarray:
        if depth_file.endswith(".npz"):
            return read_npz_depth(depth_file, "velodyne")
        if depth_file.endswith(".png"):
            return read_png_depth(depth_file)
        raise NotImplementedError(f"Depth type {self.depth_type} not implemented")

    def _context_indices(self, sample: str, back: int, fwd: int, stride: int):
        base, ext = os.path.splitext(os.path.basename(sample))
        folder = os.path.dirname(sample)
        f_idx = int(base)
        if folder not in self._folder_size_cache:
            self._folder_size_cache[folder] = len(
                glob.glob(os.path.join(folder, "*" + ext)))
        max_files = self._folder_size_cache[folder]
        if f_idx - back * stride < 0 or f_idx + fwd * stride >= max_files:
            return None, None
        back_idxs, c = [], f_idx
        while len(back_idxs) < back and c > 0:
            c -= stride
            if os.path.exists(self._neighbor_file(c, sample)):
                back_idxs.append(c)
        if c < 0:
            return None, None
        fwd_idxs, c = [], f_idx
        while len(fwd_idxs) < fwd and c < max_files:
            c += stride
            if os.path.exists(self._neighbor_file(c, sample)):
                fwd_idxs.append(c)
        if c >= max_files:
            return None, None
        return back_idxs, fwd_idxs

    # ---------------------------------------------------------------- calib

    def _calib(self, image_file: str) -> dict:
        folder = self._parent_folder(image_file)
        if folder not in self._calib_cache:
            self._calib_cache[folder] = read_calib_file(
                os.path.join(folder, CALIB_FILE["cam2cam"]))
        return self._calib_cache[folder]

    def _intrinsics(self, image_file: str) -> np.ndarray:
        calib = self._calib(image_file)
        for cam in ("left", "right"):
            if IMAGE_FOLDER[cam] in image_file:
                key = IMAGE_FOLDER[cam].replace("image", "P_rect")
                return np.reshape(calib[key], (3, 4))[:, :3].astype(np.float32)
        raise ValueError(f"Cannot find camera for {image_file}")

    # ---------------------------------------------------------------- poses

    def _imu2cam(self, image_file: str) -> np.ndarray:
        folder = self._parent_folder(image_file)
        if folder not in self._imu2cam_cache:
            cam2cam = read_calib_file(os.path.join(folder, CALIB_FILE["cam2cam"]))
            imu2velo = read_calib_file(os.path.join(folder, CALIB_FILE["imu2velo"]))
            velo2cam = read_calib_file(os.path.join(folder, CALIB_FILE["velo2cam"]))
            velo2cam_mat = transform_from_rot_trans(velo2cam["R"], velo2cam["T"])
            imu2velo_mat = transform_from_rot_trans(imu2velo["R"], imu2velo["T"])
            cam2rect_mat = transform_from_rot_trans(cam2cam["R_rect_00"], np.zeros(3))
            self._imu2cam_cache[folder] = cam2rect_mat @ velo2cam_mat @ imu2velo_mat
        return self._imu2cam_cache[folder]

    def _oxts(self, image_file: str) -> np.ndarray:
        for cam in ("left", "right"):
            if IMAGE_FOLDER[cam] in image_file:
                oxts_file = image_file.replace(
                    IMAGE_FOLDER[cam], OXTS_POSE_DATA).replace(".png", ".txt")
                break
        else:
            raise ValueError("Invalid KITTI path for pose supervision.")
        if oxts_file not in self._oxts_cache:
            self._oxts_cache[oxts_file] = np.loadtxt(oxts_file, delimiter=" ")
        return self._oxts_cache[oxts_file]

    def _pose(self, image_file: str) -> np.ndarray:
        """World pose of the camera at this frame, relative to frame 0 of the
        sequence."""
        if image_file in self._pose_cache:
            return self._pose_cache[image_file]
        base, ext = os.path.splitext(os.path.basename(image_file))
        origin_frame = os.path.join(
            os.path.dirname(image_file), str(0).zfill(len(base)) + ext)
        origin_oxts = self._oxts(origin_frame)
        scale = np.cos(origin_oxts[0] * np.pi / 180.0)
        origin_pose = transform_from_rot_trans(*pose_from_oxts_packet(origin_oxts, scale))
        cur = transform_from_rot_trans(*pose_from_oxts_packet(self._oxts(image_file), scale))
        imu2cam = self._imu2cam(image_file)
        odo = (imu2cam @ np.linalg.inv(origin_pose) @ cur @
               np.linalg.inv(imu2cam)).astype(np.float32)
        self._pose_cache[image_file] = odo
        return odo

    # ------------------------------------------------------------- samples

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, idx: int) -> dict:
        path = self.paths[idx]
        sample = {
            "idx": idx,
            "filename": f"{self.split}_{idx:010d}",
            "rgb": load_image_u8(path),
            "intrinsics": self._intrinsics(path),
        }
        if self.with_pose:
            sample["pose"] = self._pose(path)
        if self.with_depth:
            sample["depth"] = self._read_depth(self._depth_file(path, self.depth_type))
        if self.with_input_depth:
            sample["input_depth"] = self._read_depth(
                self._depth_file(path, self.input_depth_type))
        if self.with_context:
            ctx_idxs = list(self.backward_context_idxs[idx]) + \
                list(self.forward_context_idxs[idx])
            ctx_files = [self._neighbor_file(i, path) for i in ctx_idxs]
            sample["rgb_context"] = [load_image_u8(f) for f in ctx_files]
            if self.with_pose:
                first = sample["pose"]
                sample["pose_context"] = [
                    (invert_pose_numpy(self._pose(f)) @ first).astype(np.float32)
                    for f in ctx_files]
        if self.data_transform is not None:
            sample = self.data_transform(sample, idx=idx)
        else:
            from packnet_sfm_tpu_torch.datasets.augmentations import ensure_float_sample
            sample = ensure_float_sample(sample)
        return sample
