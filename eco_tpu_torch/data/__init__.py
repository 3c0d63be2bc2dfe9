"""The host data planes: video lists, segment sampling, frame decoding and
augmentation, the prefetching ``VideoPipeline`` (float or raw uint8 batches),
the classic Caffe databases (LMDB, LevelDB, HDF5), window and segmentation
sources, the native C++ loader, and ``prefetch_to_device``.

Every module but ``device_prefetch`` is a copy of its ``eco_tpu/data``
namesake, which holds no framework code.  ``cv2`` and ``h5py`` are
optional: the modules import without them, and a function that needs one
raises when it is called.
"""

from eco_tpu_torch.data.video_list import VideoRecord, parse_video_list
from eco_tpu_torch.data.sampler import (
    frame_indices,
    sample_offsets,
    streaming_allocation,
    subsample_window,
)
from eco_tpu_torch.data.reader import read_segment_flow, read_segment_rgb
from eco_tpu_torch.data.transform import (
    TransformConfig,
    fill_crop_sizes,
    fill_fix_offsets,
    sample_random_crop_size,
    transform_stack,
)
from eco_tpu_torch.data.pipeline import VideoDataConfig, VideoPipeline
from eco_tpu_torch.data.window import WindowSource, crop_window, parse_window_file
from eco_tpu_torch.data.seg import SegSource, parse_seg_list, transform_seg
from eco_tpu_torch.data.leveldb import (
    LevelDBReader,
    LevelDBSource,
    open_db,
    sniff_backend,
)
from eco_tpu_torch.data.lmdb import (
    Datum,
    DatumBatchSource,
    LMDBReader,
    LMDBSource,
    parse_datum,
)
from eco_tpu_torch.data.db import DBDataConfig, DBPipeline
from eco_tpu_torch.data.hdf5 import HDF5Source
from eco_tpu_torch.data.device_prefetch import prefetch_to_device
