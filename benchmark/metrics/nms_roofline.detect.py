"""nms_roofline.detect: K1's (csrc/nms.cu) share of its roofline in %:
the least time of the NMS launches of the profiled stretch (bytes of the
rows, operations counted from the rows by counts/selection.py, as the
postprocess hands them to ops/postprocess.py::greedy_nms_rank) over the
kernel's device time there."""

from benchmark.counts.selection import nms_least_seconds

RECORDS = {"nms_rows": "dan_tpu_torch.ops.postprocess:greedy_nms_rank"}
KERNEL = "nms_rank_kernel"


def read(view):
    rows, t = view.records.get("nms_rows"), view.kernel_s(KERNEL)
    if not rows or not t:
        return None
    post = view.config["dan"]["postprocess"]
    least = sum(nms_least_seconds(args[0], args[1], post["nms_iou_threshold"],
                                  post["max_detections"]) for args, _ in rows)
    return 100.0 * least / t
