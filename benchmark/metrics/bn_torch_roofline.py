"""The training BatchNorms left on torch's ops: their share of their
roofline in a training step.

The byte bound of the BNs the program's ``bn_torch`` counter saw in the
traced steps, 5 x ``bn_torch_bytes`` / 3.35 TB/s (x in and y out forward,
g and x in and dx out backward: the convention of ``bn_train_roofline``),
over the device time of torch's batch-norm kernels, named as the card's
trace shows them (``batch_norm_collect_statistics_channels_last_kernel``
and the rest of ``batch_norm_*``; cuDNN's ``bn_fw_tr_*`` / ``bn_bw_*``).
Read only when the counter saw a BN and those kernels took time; a program
without the counter reads nothing.

The share holds for a one-process step without remat, as every training
cell runs.  There each counted BN is one ``F.batch_norm`` forward and one
backward.  The global-batch DP step's moments (``forward_moments``) run on
elementwise ops, which add bytes but no ``batch_norm_`` time, and a remat
recompute counts its BN a second time at five passes for one more forward:
in either the share would read high."""

from benchmark.harness.peaks import HBM_BYTES_PER_S

KERNELS = ("batch_norm_", "bn_fw_tr_", "bn_bw_")
PASSES = 5


def read(r):
    if r.kind != "train" or r.tracer is None or not r.counters.get("bn_torch"):
        return None
    device_s = sum(s for n, s in r.tracer.seconds_by_name().items()
                   if any(k in n for k in KERNELS))
    if device_s <= 0:
        return None
    return 100.0 * PASSES * r.counters["bn_torch_bytes"] / HBM_BYTES_PER_S / device_s
