from eco_tpu_torch.runtime.executor import IMPLS, Program, get_impl
from eco_tpu_torch.runtime.init import fill
