from eco_tpu_torch.apps.serving import UInt8Server
