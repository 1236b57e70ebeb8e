"""K5's share of its roofline: the bytes the splat prediction must move in the
traced frames (``harness/work.splat``) at 3.35 TB/s, over the device time of
its kernels in the trace."""

from harness import work

LAYER = "kernels"
SOURCE = "device_trace"
MOVES = "fps"
UNIT = "%"
KERNELS = ("splat_votes_kernel", "splat_tiles_kernel")


def read(run):
    recs = run.work[run.traced_first:run.traced_first + run.traced_frames]
    if run.trace is None or not recs:
        return None
    secs, launches = run.trace.kernel_seconds(KERNELS)
    if secs <= 0 or launches == 0:
        return None
    b3 = run.engine["tsdf"]["block_size"] ** 3
    hw = run.engine["intrinsics"]["width"] * run.engine["intrinsics"]["height"]
    least = sum(work.least_seconds(*work.splat(r["k"], r["listed"], b3, hw, r["pred_color"]))
                for r in recs)
    return 100.0 * least / secs
