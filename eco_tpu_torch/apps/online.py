"""Online (streaming) video recognition -- parity with
scripts/online_recognition/online_recognition.py, batched on the card.

Twin of ``eco_tpu/apps/online.py``, with the reference's semantics kept bug
for bug:
- frames accumulate into 16-frame windows; up to 5 historical windows kept;
- the sampling-memory schedule ``algo = [[16],[8,8],[4,4,8],[2,2,4,8],
  [1,1,2,4,8]]`` allocates how many frames each window contributes (newer
  windows contribute more), each window subsampled by rint(linspace)
  (online_recognition.py:23,64-83);
- window memory is DESTRUCTIVE by default, as in the reference: each tick
  overwrites ``running_frames[y]`` with its subsample
  (online_recognition.py:74-77), so an aging window degrades cumulatively
  (16 -> 8 -> 4 -> 2 -> 1 frames as it moves down the schedule).
  ``window_memory="full"`` keeps full windows and resamples fresh each tick;
- each frame: resize to 256x340, center-crop crop_size, BGR mean subtract
  (:85-92);
- prediction = argmax of the *running mean* of the output logits over all
  forwards so far (:94-98).

``MultiStreamRecognizer`` runs many independent streams in one batched
forward (videos ride the batch axis), padded to a fixed batch of
``num_streams`` every tick, so the forward always sees one shape.

The planes: ``plane="f32"`` does resize, crop and mean on the host (needs
``cv2``); ``plane="uint8"`` does resize and crop on the host and ships uint8
crops, and the crop/normalize kernel (``ops/preprocess.py``) subtracts the
mean and casts on the program's device.  On an int8-quantized graph the
kernel quantizes the clips and conv1 is fed int8 (``int8_input_rewrite``),
so every int8 layer runs through the int8 conv kernel.  The logits come back
to the host once per tick.  The reference's ``interpret=`` argument (Pallas
interpret mode off the TPU) has no counterpart here.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from eco_tpu_torch.convert.quantize import int8_input_rewrite
from eco_tpu_torch.data.sampler import streaming_allocation, subsample_window
from eco_tpu_torch.ops.preprocess import preprocess_on_device
from eco_tpu_torch.runtime.executor import Program

BGR_MEAN = np.asarray([104.0, 117.0, 123.0], np.float32)


def preprocess_frame(
    frame: np.ndarray, *, crop_size: int = 224, resize_hw=(256, 340),
    mean: np.ndarray = BGR_MEAN,
) -> np.ndarray:
    """BGR uint8 (H, W, 3) -> float32 (crop, crop, 3), center crop + mean."""
    import cv2

    if frame.shape[:2] != tuple(resize_hw):
        frame = cv2.resize(frame, (resize_hw[1], resize_hw[0]))
    h, w = frame.shape[:2]
    y = (h - crop_size) // 2
    x = (w - crop_size) // 2
    patch = frame[y:y + crop_size, x:x + crop_size].astype(np.float32)
    return patch - mean


def preprocess_frame_u8(
    frame: np.ndarray, *, crop_size: int = 224, resize_hw=(256, 340),
) -> np.ndarray:
    """The uint8 plane: resize + center crop only, no float math on the host.
    ``cv2`` is needed only when the frame is not ``resize_hw`` already."""
    if frame.shape[:2] != tuple(resize_hw):
        import cv2

        frame = cv2.resize(frame, (resize_hw[1], resize_hw[0]))
    h, w = frame.shape[:2]
    y = (h - crop_size) // 2
    x = (w - crop_size) // 2
    return np.ascontiguousarray(frame[y:y + crop_size, x:x + crop_size])


@dataclass
class _StreamState:
    windows: list = field(default_factory=list)  # list of lists of frames
    pending: list = field(default_factory=list)
    logit_sum: Optional[np.ndarray] = None
    n_forwards: int = 0


class OnlineRecognizer:
    """Single-stream runner. Feed frames; get (label_idx, smoothed_logits)
    whenever a window completes (None otherwise).  The forward runs on the
    program's device."""

    def __init__(
        self,
        program,
        params,
        state,
        *,
        num_segments: int = 16,
        crop_size: int = 224,
        max_windows: int = 5,
        output: str = None,
        window_memory: str = "destructive",
        plane: str = "f32",
        mean=tuple(BGR_MEAN),
    ):
        self.params = params
        self.state = state
        self.num_segments = num_segments
        self.crop_size = crop_size
        self.max_windows = max_windows
        if window_memory not in ("destructive", "full"):
            raise ValueError(f"window_memory {window_memory!r}")
        self.window_memory = window_memory
        if plane not in ("f32", "uint8"):
            raise ValueError(f"plane {plane!r} (use 'f32' or 'uint8')")
        self.plane = plane
        self.mean = mean
        self.output = output or (
            "probs" if "probs" in program.output_names else program.output_names[-1]
        )
        self.in_scale = None
        if plane == "uint8":
            # int8-quantized graph: the kernel quantizes the clips and conv1
            # is fed int8 (a no-op on float graphs)
            graph, self.in_scale = int8_input_rewrite(program.graph)
            if self.in_scale is not None:
                program = Program(graph, compute_dtype=program.compute_dtype,
                                  device=program.device)
        self.program = program
        self._stream = _StreamState()

    def _forward(self, clips: Sequence[Sequence[np.ndarray]], batch: int = 1) -> np.ndarray:
        """Host clips, each a list of S frames (crop, crop, 3), padded with
        zero clips to ``batch`` -> (batch, ...) f32 host logits.  The frames
        are written straight into one pinned buffer when the program is on a
        card (one host copy of each frame), copied without a blocking copy,
        and the logits read back once."""
        dev = self.program.device
        first = clips[0][0]
        data = torch.empty((max(batch, len(clips)), len(clips[0]), *first.shape),
                           dtype=torch.from_numpy(first[:0]).dtype,
                           pin_memory=dev.type == "cuda")
        host = data.numpy()
        host[len(clips):] = 0
        for i, clip in enumerate(clips):
            for j, frame in enumerate(clip):
                host[i, j] = frame
        data = data.to(dev, non_blocking=True)
        if self.plane == "uint8":
            n = data.shape[0]
            # host offsets and flags: one small copy, no stream sync
            data = preprocess_on_device(
                data, [0] * n, [0] * n, [False] * n, crop=self.crop_size,
                mean=self.mean, out_dtype=self.program.compute_dtype or torch.float32,
                act_scale=self.in_scale)
        with torch.no_grad():
            outs, _ = self.program.apply(self.params, self.state, {"data": data},
                                         capture=[self.output])
        return outs[self.output].float().cpu().numpy()

    def _preprocess(self, frame: np.ndarray) -> np.ndarray:
        if self.plane == "uint8":
            return preprocess_frame_u8(frame, crop_size=self.crop_size)
        return preprocess_frame(frame, crop_size=self.crop_size)

    def _assemble(self, s: _StreamState) -> list:
        alloc = streaming_allocation(len(s.windows), self.num_segments)
        # oldest window first, newest last; newest gets the most frames
        windows = s.windows[-len(alloc):]
        subsampled = [
            subsample_window(w, count) for w, count in zip(windows, alloc)
        ]
        if self.window_memory == "destructive":
            # bug-for-bug reference parity: the subsample REPLACES the stored
            # window (online_recognition.py:74-77), so older windows degrade
            # cumulatively across ticks
            s.windows = subsampled
        frames = [f for w in subsampled for f in w]
        if len(frames) != self.num_segments:
            raise AssertionError(f"{len(frames)} frames for {self.num_segments} segments")
        return frames  # S frames (crop, crop, 3), stacked by _forward

    def push_frame(self, frame: np.ndarray):
        """frame: BGR uint8. Returns (label, logits) after each full window."""
        s = self._stream
        s.pending.append(self._preprocess(frame))
        if len(s.pending) < self.num_segments:
            return None
        s.windows.append(s.pending)
        s.pending = []
        if len(s.windows) > self.max_windows:
            s.windows = s.windows[-self.max_windows:]
        logits = self._forward([self._assemble(s)])[0]
        if s.logit_sum is None:
            s.logit_sum = np.zeros_like(logits, np.float32)
        s.logit_sum += logits
        s.n_forwards += 1
        smoothed = s.logit_sum / s.n_forwards
        return int(np.argmax(smoothed)), smoothed


def run_capture_loop(
    recognizer: "OnlineRecognizer",
    capture,
    *,
    class_names: Optional[Sequence[str]] = None,
    display: bool = False,
    max_frames: Optional[int] = None,
    on_prediction=None,
):
    """The reference's interactive webcam shell
    (online_recognition.py:50-62,99-105): read frames from ``capture``
    (anything with ``read() -> (ok, BGR frame)``, e.g. ``cv2.VideoCapture``),
    overlay the latest prediction with ``cv2.putText``, and show the live
    window when ``display=True`` ('q' quits, :104-105).  Headless by
    default, and then ``cv2`` is not needed.

    Returns the list of (frame_index, label_index, label_text) prediction
    ticks.  ``on_prediction(frame_idx, label_idx, text)`` fires at each
    window tick (the reference prints/overlays there).
    """
    if display:
        import cv2

    text = ""
    ticks = []
    i = 0
    while max_frames is None or i < max_frames:
        ok, frame = capture.read()
        if not ok or frame is None:
            break
        if display:
            shown = frame.copy()
            cv2.putText(shown, text, (10, 80), cv2.FONT_HERSHEY_SIMPLEX,
                        0.8, (0, 255, 255), thickness=2)
            cv2.imshow("Frames", shown)
            if cv2.waitKey(1) & 0xFF == ord("q"):
                break
        res = recognizer.push_frame(frame)
        i += 1
        if res is not None:
            idx, _ = res
            label = class_names[idx] if class_names else str(idx)
            text = "Action: " + label
            ticks.append((i, idx, label))
            if on_prediction is not None:
                on_prediction(i, idx, label)
    if display:
        cv2.destroyAllWindows()
    return ticks


class _FrameDirCapture:
    """``cv2.VideoCapture``-shaped reader over a directory of frames, so the
    same ``run_capture_loop`` drives files and cameras alike."""

    def __init__(self, path: str):
        import os

        self._dir = path
        self._names = sorted(os.listdir(path))
        self._i = 0

    def read(self):
        import os

        import cv2

        while self._i < len(self._names):
            p = os.path.join(self._dir, self._names[self._i])
            self._i += 1
            img = cv2.imread(p)
            if img is not None:
                return True, img
        return False, None

    def release(self):
        pass


class MultiStreamRecognizer:
    """Many concurrent streams, one batched forward per window tick.

    All streams must tick together (same frame rate).  Every tick's batch is
    padded to ``num_streams`` clips, so the forward sees one shape (and
    cuDNN, which may pick its algorithm by batch size, one algorithm).
    """

    def __init__(self, program, params, state, *, num_streams: int,
                 num_segments: int = 16, crop_size: int = 224,
                 max_windows: int = 5, output: str = None,
                 window_memory: str = "destructive",
                 plane: str = "f32",
                 num_workers: int = 0):
        self.n = num_streams
        self.single = OnlineRecognizer(
            program, params, state, num_segments=num_segments,
            crop_size=crop_size, max_windows=max_windows, output=output,
            window_memory=window_memory, plane=plane,
        )
        self._streams = [_StreamState() for _ in range(num_streams)]
        # per-frame cv2 preprocessing releases the GIL; on multi-core serving
        # hosts a pool keeps the host side off the critical path
        self._pool = None
        if num_workers:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(max_workers=num_workers)

    def close(self):
        """Shut down the preprocessing worker pool (idempotent)."""
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def push_frames(self, frames: Sequence[np.ndarray]):
        """One frame per stream. Returns list of (label, smoothed) or None."""
        if len(frames) != self.n:
            raise ValueError(f"{len(frames)} frames for {self.n} streams")
        if self._pool is not None:
            pre = list(self._pool.map(self.single._preprocess, frames))
        else:
            pre = [self.single._preprocess(f) for f in frames]
        ready = []
        for s, frame in zip(self._streams, pre):
            s.pending.append(frame)
            if len(s.pending) >= self.single.num_segments:
                s.windows.append(s.pending)
                s.pending = []
                if len(s.windows) > self.single.max_windows:
                    s.windows = s.windows[-self.single.max_windows:]
                ready.append(s)
        if not ready:
            return [None] * self.n
        # padded to a fixed batch of num_streams (zero clips)
        logits = self.single._forward([self.single._assemble(s) for s in ready], self.n)
        ready_ids = {id(s) for s in ready}
        results: list = []
        k = 0
        for s in self._streams:
            if id(s) in ready_ids:
                if s.logit_sum is None:
                    s.logit_sum = np.zeros_like(logits[k], np.float32)
                s.logit_sum += logits[k]
                s.n_forwards += 1
                k += 1
                smoothed = s.logit_sum / s.n_forwards
                results.append((int(np.argmax(smoothed)), smoothed))
            else:
                results.append(None)
        return results
