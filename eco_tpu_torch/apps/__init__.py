from eco_tpu_torch.apps.serving import RawPreprocessProgram, UInt8Server
