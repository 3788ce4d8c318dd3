"""Host-side utilities (counterpart of dan_tpu/utils): the metrics log,
the profiler trace and throughput meter, and detection drawing; and the
two TF file-format helpers that the checkpoint bundle (ckpt/tf_bundle.py)
and the TFRecord reader (data/tfrecords.py) share: CRC-32C and the
protobuf wire format."""
