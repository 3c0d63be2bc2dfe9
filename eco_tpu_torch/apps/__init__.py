from eco_tpu_torch.apps.online import (
    MultiStreamRecognizer,
    OnlineRecognizer,
    preprocess_frame,
)
from eco_tpu_torch.apps.serving import RawPreprocessProgram, UInt8Server
from eco_tpu_torch.apps.tsn_eval import OversampleEvaluator, oversample_video, ten_crop
