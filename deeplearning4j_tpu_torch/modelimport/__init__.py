"""Model import — the port's part of `deeplearning4j_tpu/modelimport`: the
TF GraphDef importer (`tensorflow.py`) over its own wire codec
(`_tf/wire.py`).  Keras and ONNX import wait (ROADMAP A13)."""
