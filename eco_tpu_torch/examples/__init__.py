"""The user workflows, runnable as ``python -m eco_tpu_torch.examples.<name>``.

Each is the twin of the script of the same name under the repository's
``examples/`` (the ``eco_tpu`` versions), keeps its flags and defaults, adds
``--device`` (the card, ``cuda``, unless the caller names another), and
prints its results as one JSON object on the last line:

- ``train_synthetic``: train ECO-Lite on a fabricated JPEG frame dataset
  through the data pipeline and the ``Trainer``, then test it
  (``examples/train_synthetic.py``);
- ``serve_streams``: N camera streams through ``MultiStreamRecognizer``, one
  batched forward a window tick (``examples/serve_streams.py``);
- ``quantized_serving``: int8 post-training quantization beside the bf16
  graph: agreement and videos/s of both (``examples/quantized_serving.py``);
- ``aot_artifact``: a ``torch.export`` serving artifact, loaded and checked
  by a process that cannot import this package (``examples/aot_artifact.py``).
"""
