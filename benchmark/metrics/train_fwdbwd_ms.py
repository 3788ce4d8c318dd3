"""train_fwdbwd_ms: ms of device time a step spends in
train/loop.py::loss_and_grads (forward, loss, backward with K5, K6 and the
upsample gradient), from CUDA events around each call of the profiled
stretch."""

SPANS = {"loss_and_grads": "dan_tpu_torch.train.loop:loss_and_grads"}


def read(view):
    return view.span_mean_ms("loss_and_grads")
