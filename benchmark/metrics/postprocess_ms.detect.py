"""postprocess_ms.detect: ms of device time a call spends in
ops/postprocess.py::postprocess_batch (softmax, decode, filter, top-k, the
NMS kernel of ops/nms_cuda.py), from CUDA events around each call the
bench path (tools/bench.py) makes in the profiled stretch."""

SPANS = {"postprocess": "dan_tpu_torch.tools.bench:postprocess_batch"}


def read(view):
    return view.span_mean_ms("postprocess")
