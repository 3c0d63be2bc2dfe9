"""TSN-style oversampled evaluation -- parity with
caffe_3d/action_python/VideoSpatialPrediction.py:31-78 (RGB) and
VideoTemporalPrediction.py (stacked optical flow).

Spatial protocol: sample ``num_frames`` (default 25) frames evenly across the
video, resize to 256x340, take 10 crops per frame (4 corners + center, each
mirrored), forward all crops, average the logits/probs over every crop and
frame for the video-level prediction.

Temporal protocol: at each of ``num_samples`` positions stack
``optical_flow_frames`` consecutive (flow_x, flow_y) pairs into a
2L-channel image; the 5 mirrored crops negate the x channels (255 - v),
exactly the reference's ``flow_flip`` (VideoTemporalPrediction.py:49-51).

Twin of ``eco_tpu/apps/tsn_eval.py``: the host code (frame choice, crops,
flow negation) is the reference's; the forward is ``Program.apply`` on the
program's device, all crops of a video in one batch.
"""


from __future__ import annotations

import os

import numpy as np
import torch

BGR_MEAN = np.asarray([104.0, 117.0, 123.0], np.float32)


def ten_crop(img: np.ndarray, crop: int = 224) -> np.ndarray:
    """(H, W, 3) -> (10, crop, crop, 3): 4 corners + center, + mirrors."""
    h, w = img.shape[:2]
    offs = [
        (0, 0), (0, w - crop), (h - crop, 0), (h - crop, w - crop),
        ((h - crop) // 2, (w - crop) // 2),
    ]
    crops = [img[y:y + crop, x:x + crop] for y, x in offs]
    crops += [c[:, ::-1] for c in crops]
    return np.stack(crops)


def oversample_video(
    video_path: str,
    n_video_frames: int,
    *,
    num_frames: int = 25,
    num_segments: int = 16,
    crop: int = 224,
    name_pattern: str = "img_%04d.jpg",
    resize_hw=(256, 340),
    frame_rule: str = "reference",
) -> np.ndarray:
    """Returns (10, num_segments*ceil(num_frames/num_segments)...) stacks.

    For ECO the clip unit is ``num_segments`` frames; we build one clip per
    crop position from ``num_frames`` sampled frames subsampled to
    ``num_segments`` (linspace), i.e. (10, S, crop, crop, 3) float32.

    ``frame_rule="reference"`` (default) picks the exact frames the paper
    protocol reads: file index ``i*step + 1`` with
    ``step = floor((duration-1)/(num_samples-1))``
    (VideoSpatialPrediction.py:32-38).  ``"linspace"`` spreads the samples
    end-inclusive instead (covers the video tail when duration is not close
    to a multiple of num_frames).
    """
    import cv2

    if frame_rule == "reference":
        step = (n_video_frames - 1) // max(num_frames - 1, 1)
        idx = np.arange(num_frames, dtype=np.int64) * step
    elif frame_rule == "linspace":
        idx = np.linspace(0, n_video_frames - 1, num_frames).astype(np.int64)
    else:
        raise ValueError(f"unknown frame_rule {frame_rule!r}")
    sub = np.linspace(0, num_frames - 1, num_segments).astype(np.int64)
    frames = []
    for i in idx[sub]:
        img = cv2.imread(os.path.join(video_path, name_pattern % (i + 1)))
        if img is None:
            img = frames[-1] if frames else np.zeros(
                (resize_hw[0], resize_hw[1], 3), np.uint8
            )
        else:
            img = cv2.resize(img, (resize_hw[1], resize_hw[0]))
        frames.append(img)
    stacks = np.stack([ten_crop(f, crop) for f in frames])  # (S, 10, c, c, 3)
    stacks = stacks.transpose(1, 0, 2, 3, 4).astype(np.float32) - BGR_MEAN
    return stacks  # (10, S, crop, crop, 3)


def ten_crop_flow(stack: np.ndarray, crop: int = 224) -> np.ndarray:
    """(H, W, 2L) interleaved (x, y) -> (10, crop, crop, 2L).

    The 5 mirrored crops flip horizontally AND negate the x channels
    (channels 0, 2, 4, ...): 255 - v, the reference's flow_flip
    (VideoTemporalPrediction.py:49-51, io.cpp:498-623 mirror rule).
    """
    h, w = stack.shape[:2]
    offs = [
        (0, 0), (0, w - crop), ((h - crop) // 2, (w - crop) // 2),
        (h - crop, 0), (h - crop, w - crop),
    ]
    flipped = stack[:, ::-1].copy()
    flipped[..., 0::2] = 255.0 - flipped[..., 0::2]
    crops = [stack[y:y + crop, x:x + crop] for y, x in offs]
    crops += [flipped[y:y + crop, x:x + crop] for y, x in offs]
    return np.stack(crops)


def oversample_flow_video(
    video_path: str,
    n_video_frames: int,
    *,
    num_samples: int = 25,
    optical_flow_frames: int = 5,
    crop: int = 224,
    name_pattern: str = "flow_%05d.jpg",
    resize_hw=(256, 340),
    mean: float = 128.0,
) -> np.ndarray:
    """Returns (10, num_samples, crop, crop, 2*optical_flow_frames) float32.

    Frame selection matches the reference: position i uses consecutive flow
    pairs i*step + j, step = floor((duration - L + 1) / num_samples)
    (VideoTemporalPrediction.py:33-43).  Flow frames live in ``flow_x/`` and
    ``flow_y/`` subdirs named by ``name_pattern`` (our reader convention).
    """
    from eco_tpu_torch.data.reader import read_segment_flow

    L = optical_flow_frames
    step = max(1, (n_video_frames - L + 1) // num_samples)
    idx = np.minimum(
        np.arange(num_samples)[:, None] * step + np.arange(L)[None, :],
        n_video_frames - 1,
    )  # (num_samples, L)
    pairs = read_segment_flow(
        video_path, idx, name_pattern=name_pattern,
        new_height=resize_hw[0], new_width=resize_hw[1],
    )  # (num_samples*L, H, W, 2), channel 0 = flow_x, 1 = flow_y
    h, w = pairs.shape[1:3]
    # (S, L, H, W, 2) -> (S, H, W, L*2): channels [fx_0, fy_0, fx_1, fy_1...]
    samples = list(
        pairs.reshape(num_samples, L, h, w, 2)
        .transpose(0, 2, 3, 1, 4)
        .reshape(num_samples, h, w, 2 * L)
    )
    crops = np.stack(
        [ten_crop_flow(s.astype(np.float32), crop) for s in samples]
    )  # (num_samples, 10, crop, crop, 2L)
    crops = crops.transpose(1, 0, 2, 3, 4) - np.float32(mean)
    return crops.astype(np.float32)  # (10, S, crop, crop, 2L)


class OversampleEvaluator:
    """Batched 10-crop evaluation of a video list on the program's device."""

    def __init__(self, program, params, state, *, output: str = None):
        self.program = program
        self.params = params
        self.state = state
        self.output = output or (
            "probs" if "probs" in program.output_names else program.output_names[-1]
        )

    def _fwd(self, crops: np.ndarray) -> np.ndarray:
        data = torch.from_numpy(crops).to(self.program.device)
        with torch.no_grad():
            outs, _ = self.program.apply(self.params, self.state, {"data": data},
                                         capture=[self.output])
        return outs[self.output].float().cpu().numpy()

    def predict_video(self, video_path: str, n_frames: int, **kw) -> np.ndarray:
        """Average prediction over the 10 crops; returns (num_classes,)."""
        crops = oversample_video(video_path, n_frames, **kw)
        scores = self._fwd(crops)
        return scores.mean(axis=0)

    def predict_flow_video(self, video_path: str, n_frames: int, **kw) -> np.ndarray:
        """Temporal-network prediction over stacked optical flow
        (VideoTemporalPrediction parity); returns (num_classes,)."""
        crops = oversample_flow_video(video_path, n_frames, **kw)
        scores = self._fwd(crops)
        return scores.mean(axis=0)

    def evaluate(self, records, *, modality: str = "RGB", **kw):
        """Top-1 accuracy over [(path, n_frames, label)] records."""
        predict = (
            self.predict_flow_video if modality.upper() == "FLOW"
            else self.predict_video
        )
        correct = 0
        for rec in records:
            pred = predict(rec.path, rec.num_frames, **kw)
            correct += int(np.argmax(pred) == rec.label)
        return correct / max(len(records), 1)
