"""The CUDA kernels against their plain PyTorch versions, on a card.

Needs an NVIDIA GPU and the CUDA toolkit; every test skips without a card.
The file imports neither JAX nor the reference package, so it also runs on
a machine that has only PyTorch (the conftest, which pins JAX to the CPU,
is left out there):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from instancefusion_tpu_torch.config import (
    EngineConfig, IcpConfig, InstanceConfig, RaycastConfig, TsdfConfig,
)
from instancefusion_tpu_torch.datasets import synthetic
from instancefusion_tpu_torch.engine import slam
from instancefusion_tpu_torch.geometry.camera import Intrinsics
from instancefusion_tpu_torch.geometry.se3 import se3_exp, se3_inverse
from instancefusion_tpu_torch.ops import blocks, icp, kernels, labels, preprocess
from instancefusion_tpu_torch.ops.common import decimate
from instancefusion_tpu_torch.ops.kernels import icp as kicp
from instancefusion_tpu_torch.ops.kernels import labels as klab
from instancefusion_tpu_torch.ops.kernels import preprocess as kpre
from instancefusion_tpu_torch.ops.kernels import raycast as kray
from instancefusion_tpu_torch.ops.kernels import tsdf as ktsdf

# The test-scale block-map configuration of tests/test_splat.py, with
# instances on (config3's structure).
CFG = EngineConfig(
    intrinsics=Intrinsics(fx=129.3, fy=129.1, cx=79.5, cy=59.5, width=160, height=120),
    tsdf=TsdfConfig(voxel_size=0.04, trunc=0.12, grid_size=96,
                    origin=(-1.92, -1.92, -0.4), block_size=8,
                    table_capacity=1728, touched_capacity=512),
    icp=IcpConfig(iters=(10, 7, 7), min_valid=60),
    raycast=RaycastConfig(near=0.2, far=4.0, use_depth_prior=True,
                          screen_space_normals=True, use_splat=True, splat_rmax=3),
    map_kind="blocks",
    use_instances=True,
    instances=InstanceConfig(max_instances=16, num_classes=8, min_mask_pixels=50),
)
K = 512
pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def run():
    """Four frames of the engine on the card (ground-truth segmentations on
    frames 1 and 3), and the next frame's inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only on the GPU")
    poses = synthetic.orbit_trajectory(12)
    frames = [synthetic.render_frame(poses[i], CFG.intrinsics) for i in range(6)]
    kernels.reset_launches()
    state = slam.init_state(CFG, poses[0])
    for i, f in enumerate(frames[:4]):
        if i % 2:
            seg = synthetic.gt_segmentation(f.instance, CFG.instances.max_instances)
            state, info = slam.step_seg(CFG, state, f.depth, f.color, seg)
        else:
            state, info = slam.step(CFG, state, f.depth, f.color)
        assert bool(info.track_ok)
    launches = {k: fn.launches for k, fn in kernels.wrappers().items()}
    return state, frames[4], launches


def test_main_path_launches_every_kernel(run):
    _, _, launches = run
    rounds = sum(icp.level_schedule(CFG.icp, lvl)[1] for lvl in range(CFG.icp.levels))
    assert launches == {"K1": 4, "K2": 4 * rounds, "K3": 4 * rounds, "K4": 4,
                        "K5": 4, "K6": 0, "K7": 2, "K8": 0}


def _level0(state, frame):
    pyr = preprocess.build_frame_pyramid(frame.depth, CFG.intrinsics, CFG.preprocess, 1)
    return pyr[0]


def _level_args(state, frame, lvl, intensity=False):
    """K2's arguments at pyramid level `lvl`: the frame's source maps of
    the level, the state's pose and prediction view, the level's
    intrinsics, the full-resolution prediction and the stride; with
    `intensity` also the level's photometric planes."""
    pyr = preprocess.build_frame_pyramid(
        frame.depth, CFG.intrinsics, CFG.preprocess, lvl + 1,
        preprocess.rgb_to_intensity(frame.color) if intensity else None)
    src = pyr[lvl]
    pred = state.pred
    args = (src["vmap"].reshape(-1, 3).contiguous(), src["valid"].reshape(-1).contiguous(),
            state.T_wc.contiguous(), se3_inverse(state.pred_T_wc), CFG.intrinsics.level(lvl),
            *(x.contiguous() for x in (pred.vertex_w, pred.normal_w, pred.valid)), 1 << lvl)
    if not intensity:
        return args
    ti = decimate(preprocess.rgb_to_intensity(pred.color), 1 << lvl).contiguous()
    return args, (ti, *icp.intensity_gradients(ti))


@pytest.mark.parametrize("lvl", [0, 1, 2])
def test_gather_kernel_matches_plain(run, lvl):
    """The fused association (K2) at each pyramid level, bit-identical to
    its plain version: q_w, n_t, ok and the gate."""
    state, frame, _ = run
    args = _level_args(state, frame, lvl)
    before = kicp.associate_gather.launches
    out = kicp.associate_gather(*args)
    ref = kicp.associate_gather_ref(*args)
    assert kicp.associate_gather.launches == before + 1
    assert int(out.ok.sum()) > 0.3 * out.ok.numel() and out.rgb is None
    for a, b in zip(out[:4], ref[:4]):
        assert torch.equal(a, b)  # bit-identical association


def _gn_inputs(state, frame):
    """K3's arguments on the main path's state: level 0 of `frame`
    associated at a seeded perturbation of the state's pose."""
    src = _level0(state, frame)
    xi = torch.tensor(np.random.default_rng(0).normal(
        scale=(0.01,) * 3 + (0.005,) * 3), dtype=torch.float32, device=state.T_wc.device)
    T_est = se3_exp(xi) @ state.T_wc
    q, n_t, ok = icp.associate(src["vmap"], src["valid"], state.pred.vertex_w,
                               state.pred.normal_w, state.pred.valid, T_est,
                               se3_inverse(state.pred_T_wc), CFG.intrinsics)
    return (src["vmap"].reshape(-1, 3).contiguous(), src["nmap"].reshape(-1, 3).contiguous(),
            q, n_t, (src["valid"].reshape(-1) & ok).float(), T_est)


GN_KW = dict(dist_thresh=0.1, angle_thresh=0.34, huber_delta=0.0, damping=1e-6,
             min_valid=60)


@pytest.mark.parametrize("inner_n", [1, 2, 4, 10])
def test_gn_kernel_matches_plain(run, inner_n):
    """Pose within 5e-5 of the plain steps (tests/test_pallas.py's bound)
    and inliers within 1e-3, for 1 to 10 steps in the one launch."""
    state, frame, _ = run
    args = _gn_inputs(state, frame)
    kw = dict(GN_KW, inner_n=inner_n)
    T_k, nin_k, _ = kicp.gn_iterations(*args, **kw)
    T_r, nin_r, _ = kicp.gn_iterations_ref(*args, **kw)
    assert (T_k - T_r).abs().max().item() < 5e-5
    assert abs(float(nin_k) - float(nin_r)) <= 1e-3 * float(nin_r)


def _slot_list(state, frame):
    d0 = _level0(state, frame)["depth"]
    vol = blocks.discover_allocate(state.volume, d0, frame.T_wc, CFG.intrinsics, CFG.tsdf)
    slots, valid = blocks.frustum_slots(vol, frame.T_wc, CFG.intrinsics, CFG.tsdf,
                                        CFG.raycast.near, CFG.raycast.far, K)
    return vol, slots, valid, d0


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _assert_bit_equal(out_k, out_r, before, rows):
    """The kernel's planes equal the plain version's bit for bit, and every
    row outside ``rows`` is as it was before on both."""
    other = torch.ones(before.shape[0], dtype=torch.bool, device=before.device)
    other[rows] = False
    assert torch.equal(_bits(out_k), _bits(out_r))
    assert torch.equal(_bits(out_r[other]), _bits(before[other]))


def _relist(slots, valid, kind):
    """The valid slots of a prefix list laid out as another list shape:
    ``prefix`` (as given), ``holes`` (the valid entries scattered over a
    list twice as long, the holes naming listed rows), ``all_invalid``
    (every entry invalid, each naming a listed row) or ``sparse_8192`` (40
    valid entries at random places in 8192)."""
    if kind == "prefix":
        return slots, valid
    rows = slots[valid]
    g = torch.Generator(device="cpu").manual_seed(len(kind))
    length = {"holes": 2 * rows.numel() + 7, "all_invalid": rows.numel(),
              "sparse_8192": 8192}[kind]
    keep = rows[:40] if kind == "sparse_8192" else rows
    if kind == "all_invalid":
        keep = keep[:0]
    at = torch.randperm(length, generator=g)[:keep.numel()].to(slots.device)
    out_slots = rows[torch.arange(length, device=slots.device) % rows.numel()].clone()
    out_valid = torch.zeros(length, dtype=torch.bool, device=slots.device)
    out_slots[at] = keep
    out_valid[at] = True
    return out_slots.contiguous(), out_valid


LISTS = ["prefix", "holes", "all_invalid", "sparse_8192"]


@pytest.mark.parametrize("with_color", [True, False])
@pytest.mark.parametrize("kind", LISTS)
def test_integrate_kernel_matches_plain(run, with_color, kind):
    """sdf, weight and color bit-equal to the plain version on every voxel,
    with color and depth only, on a prefix list, a list with holes, an
    all-invalid list and an 8192-entry list with 40 valid entries; rows
    outside the valid set are untouched."""
    state, frame, _ = run
    vol, slots, valid, d0 = _slot_list(state, frame)
    slots, valid = _relist(slots, valid, kind)
    before = [x.clone() for x in (vol.sdf, vol.weight, vol.color)]
    maps_k = [x.clone() for x in before]
    maps_r = [x.clone() for x in before]
    args = (slots, valid, d0, frame.color if with_color else None, frame.T_wc,
            CFG.intrinsics, CFG.tsdf, 4.0)
    ktsdf.integrate(vol.block_coords, *maps_k, *args)
    ktsdf.integrate_ref(vol.block_coords, *maps_r, *args)
    rows = slots[valid].long()
    assert torch.unique(rows).numel() == rows.numel()
    if kind != "all_invalid":
        assert not torch.equal(maps_k[1], before[1])  # the frame fused something
    for out_k, out_r, b in zip(maps_k, maps_r, before):
        _assert_bit_equal(out_k, out_r, b, rows)


def _device_ops(fn, reps=10):
    """Each device op's count over `reps` calls of `fn`, by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {ev.key: ev.count for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA and ev.count > 0}


def _assert_one_launch(launched, kernel, reps=10):
    assert len(launched) == 1, launched
    (name, count), = launched.items()
    # The profiler may miss an event at its window's edge, never add one.
    assert kernel in name and reps - 1 <= count <= reps, launched


@pytest.mark.parametrize("with_color", [True, False])
def test_integrate_kernel_is_one_launch(run, with_color):
    """A K4 call is one device launch of integrate_kernel and no other
    device op: the pose is inverted in the kernel."""
    state, frame, _ = run
    vol, slots, valid, d0 = _slot_list(state, frame)
    maps = [x.clone() for x in (vol.sdf, vol.weight, vol.color)]
    args = (slots, valid, d0, frame.color if with_color else None, frame.T_wc,
            CFG.intrinsics, CFG.tsdf, 4.0)
    _assert_one_launch(_device_ops(lambda: ktsdf.integrate(vol.block_coords, *maps, *args)),
                       "integrate_kernel")


def _replay_equals_eager(call, planes):
    """`call(planes)` captured in a CUDA graph and replayed on copies of
    `planes` leaves them bit-equal to an eager call on other copies."""
    eager = [x.clone() for x in planes]
    call(eager)
    captured = [x.clone() for x in planes]
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        call(captured)
    for x, x0 in zip(captured, planes):
        x.copy_(x0)
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(captured, eager):
        assert torch.equal(_bits(a), _bits(b))


def _replay_gives_eager(call, inputs):
    """`call(*inputs)` captured in a CUDA graph on zeroed copies of
    `inputs`, then replayed once the inputs are copied in, returns what an
    eager call returns, bit for bit: the graph reads its inputs at replay."""
    eager = call(*inputs)
    static = [torch.zeros_like(x) for x in inputs]
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call(*static)
    for x, x0 in zip(static, inputs):
        x.copy_(x0)
    graph.replay()
    torch.cuda.synchronize()
    assert len(out) == len(eager)
    for a, b in zip(out, eager):
        assert (a is None and b is None) or torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("radius", [2, 5])
def test_preprocess_kernel_replays_in_cuda_graph(run, radius):
    """One K1 call (a compile-time radius, and the runtime-radius instance
    with its device table of taps) replayed from a CUDA graph gives the
    eager call's level-0 maps."""
    _, frame, _ = run
    cfg = dataclasses.replace(CFG.preprocess, bilateral_radius=radius)
    _replay_gives_eager(lambda d: kpre.fused_preprocess(d, CFG.intrinsics, cfg),
                        [frame.depth])


@pytest.mark.parametrize("lvl", [0, 2])
def test_gather_kernel_replays_in_cuda_graph(run, lvl):
    """One K2 call replayed from a CUDA graph gives the eager call's q_w,
    n_t, ok and gate."""
    state, frame, _ = run
    src_v, src_ok, T, T_pinv, intr, pv, pn, pok, stride = _level_args(state, frame, lvl)
    _replay_gives_eager(
        lambda *t: kicp.associate_gather(*t[:4], intr, *t[4:], stride),
        [src_v, src_ok, T, T_pinv, pv, pn, pok])


@pytest.mark.parametrize("with_color", [False, True])
def test_splat_kernel_replays_in_cuda_graph(run, with_color):
    """One K5 call and its finish (``splat_depth`` at rmax 8) replayed from
    a CUDA graph give the eager call's depth, valid and color."""
    state, frame, _ = run
    vol, slots, valid, d0 = _slot_list(state, frame)
    _replay_gives_eager(
        lambda *t: kray.splat_depth(*t[:7], CFG.intrinsics, CFG.tsdf, with_color=with_color,
                                    depth_prior=t[7], rmax=8),
        [slots, valid, vol.block_coords, vol.sdf, vol.weight, vol.color, frame.T_wc, d0])


@pytest.mark.parametrize("with_color", [True, False])
def test_integrate_kernel_replays_in_cuda_graph(run, with_color):
    """One K4 call captured in a CUDA graph and replayed fuses as the eager
    call does."""
    state, frame, _ = run
    vol, slots, valid, d0 = _slot_list(state, frame)
    args = (slots, valid, d0, frame.color if with_color else None, frame.T_wc,
            CFG.intrinsics, CFG.tsdf, 4.0)
    _replay_equals_eager(lambda m: ktsdf.integrate(vol.block_coords, *m, *args),
                         [vol.sdf, vol.weight, vol.color])


def test_splat_kernel_matches_plain(run):
    """Valid sets within 1%, depth within 1e-3 m where both are valid: the
    kernel sums each pixel in (list, voxel) order, the plain version row
    offset first."""
    state, frame, _ = run
    vol, slots, valid, d0 = _slot_list(state, frame)
    args = (slots, valid, vol.block_coords, vol.sdf, vol.weight, vol.color,
            frame.T_wc, CFG.intrinsics, CFG.tsdf)
    before = kray.splat_planes.launches
    ik = kray.splat_depth(*args, with_color=True, depth_prior=d0, rmax=3)
    ir = kray.splat_depth_ref(*args, with_color=True, depth_prior=d0, rmax=3)
    assert kray.splat_planes.launches == before + 1
    vk, vr = ik.valid, ir.valid
    assert int(vr.sum()) > 5000
    assert int((vk ^ vr).sum()) < 0.01 * int(vr.sum())
    both = vk & vr
    assert (ik.depth - ir.depth)[both].abs().max().item() < 1e-3
    assert (ik.color - ir.color)[both].abs().max().item() < 1e-3


@pytest.mark.parametrize("with_color", [False, True])
def test_splat_kernel_matches_plain_rmax8(run, with_color):
    """K5 (and K5color) at rmax = 8, the bench's radius, on a slot list
    whose blocks' boxes span from one screen tile to many (the tiles' walk
    of ``tile_counts``): valid sets within 1%, depth and color within 1e-3
    where both are valid."""
    state, frame, _ = run
    vol, slots, valid, d0 = _slot_list(state, frame)
    box, kept = kray.footprint_boxes(slots, valid, vol.block_coords, vol.sdf, vol.weight,
                                     frame.T_wc, CFG.intrinsics, CFG.tsdf, 8)
    some = kept & (box[:, 0] <= box[:, 2])
    spans = ((box[:, 2] // kray.TILE - box[:, 0] // kray.TILE + 1)
             * (box[:, 3] // kray.TILE - box[:, 1] // kray.TILE + 1))[some]
    assert int(spans.min()) <= 2 and int(spans.max()) >= 9, spans
    args = (slots, valid, vol.block_coords, vol.sdf, vol.weight, vol.color,
            frame.T_wc, CFG.intrinsics, CFG.tsdf)
    before = kray.splat_planes.launches_color
    ik = kray.splat_depth(*args, with_color=with_color, depth_prior=d0, rmax=8)
    ir = kray.splat_depth_ref(*args, with_color=with_color, depth_prior=d0, rmax=8)
    assert kray.splat_planes.launches_color == before + int(with_color)
    vk, vr = ik.valid, ir.valid
    assert int(vr.sum()) > 5000
    assert int((vk ^ vr).sum()) < 0.01 * int(vr.sum())
    both = vk & vr
    assert (ik.depth - ir.depth)[both].abs().max().item() < 1e-3
    assert (ik.color - ir.color)[both].abs().max().item() < 1e-3


@pytest.mark.parametrize("with_color", [False, True])
def test_splat_kernel_repeats_bit_for_bit(run, with_color):
    """Two K5 calls on the same inputs give the same planes bit for bit (no
    float atomics), and a list with no valid entry gives zero planes."""
    state, frame, _ = run
    vol, slots, valid, _ = _slot_list(state, frame)
    args = (slots, valid, vol.block_coords, vol.sdf, vol.weight, vol.color,
            frame.T_wc, CFG.intrinsics, CFG.tsdf, with_color, 8)
    first = kray.splat_planes(*args)
    for _ in range(3):
        assert torch.equal(kray.splat_planes(*args), first)
    assert float(first[2].sum()) > 0.0
    none = kray.splat_planes(slots, torch.zeros_like(valid), *args[2:])
    assert not bool(none.any())


@pytest.mark.parametrize("radius", [1, 2, 4, 5, 8])
def test_preprocess_kernel_matches_plain(run, radius):
    """df and vmap within 1e-5, valid equal, nmap within 1e-3 on valid
    pixels (tests/test_pallas.py's bounds), on noisy depth with dropouts,
    at the compile-time radii (1-4) and the runtime-radius instance (5, 8)."""
    _, frame, _ = run
    cfg = dataclasses.replace(CFG.preprocess, bilateral_radius=radius)
    g = torch.Generator(device="cuda").manual_seed(0)
    depth = frame.depth + 0.004 * torch.randn(frame.depth.shape, generator=g,
                                              device="cuda") * (frame.depth > 0)
    depth = torch.where(torch.rand(depth.shape, generator=g, device="cuda") < 0.02,
                        torch.zeros_like(depth), depth)
    before = kpre.fused_preprocess.launches
    out = kpre.fused_preprocess(depth, CFG.intrinsics, cfg)
    ref = kpre.fused_preprocess_ref(depth, CFG.intrinsics, cfg)
    assert kpre.fused_preprocess.launches == before + 1
    torch.testing.assert_close(out[0], ref[0], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(out[1], ref[1], atol=1e-5, rtol=1e-5)
    assert torch.equal(out[3], ref[3]) and int(ref[3].sum()) > 5000
    v = ref[3]
    assert (out[2] - ref[2])[v].abs().max().item() < 1e-3


def _vote_case(run):
    """The touched-block list (8192 entries) of the next frame, its ground-
    truth id image and K7's other arguments."""
    state, frame, _ = run
    seg = synthetic.gt_segmentation(frame.instance, CFG.instances.max_instances)
    touched = blocks.touched_blocks_mask(frame.depth, frame.T_wc, CFG.intrinsics, CFG.tsdf)
    nb3 = blocks.num_blocks_per_axis(CFG.tsdf) ** 3
    slots, valid = blocks.compact_touched_slots(state.volume, touched, CFG.tsdf,
                                                min(8192, nb3))
    rest = (frame.depth, seg.mask_id, frame.T_wc, CFG.intrinsics, CFG.tsdf)
    return state, slots, valid, rest


@pytest.mark.parametrize("kind", LISTS)
def test_label_vote_kernel_matches_plain(run, kind):
    """Labels and counts bit-equal to the plain version on every voxel, on
    the touched list and on the other list shapes of ``_relist``; rows
    outside the valid set are untouched."""
    state, slots, valid, rest = _vote_case(run)
    slots, valid = _relist(slots, valid, kind)
    before = [state.votes.label.clone(), state.votes.count.clone()]
    planes_k = [x.clone() for x in before]
    planes_r = [x.clone() for x in before]
    klab.label_vote(state.volume.block_coords, *planes_k, slots, valid, *rest)
    klab.label_vote_ref(state.volume.block_coords, *planes_r, slots, valid, *rest)
    rows = slots[valid].long()
    assert torch.unique(rows).numel() == rows.numel()
    if kind != "all_invalid":
        assert rows.numel() >= 40
        assert not torch.equal(planes_k[1], before[1])  # the frame voted
    for out_k, out_r, b in zip(planes_k, planes_r, before):
        _assert_bit_equal(out_k, out_r, b, rows)


def test_label_vote_kernel_is_one_launch(run):
    """A K7 call is one device launch of label_vote_kernel and no other
    device op."""
    state, slots, valid, rest = _vote_case(run)
    planes = [state.votes.label.clone(), state.votes.count.clone()]
    _assert_one_launch(
        _device_ops(lambda: klab.label_vote(state.volume.block_coords, *planes, slots,
                                            valid, *rest)),
        "label_vote_kernel")


def test_label_vote_kernel_replays_in_cuda_graph(run):
    """One K7 call captured in a CUDA graph and replayed votes as the eager
    call does."""
    state, slots, valid, rest = _vote_case(run)
    _replay_equals_eager(
        lambda p: klab.label_vote(state.volume.block_coords, *p, slots, valid, *rest),
        [state.votes.label, state.votes.count])


@pytest.mark.parametrize("with_seg", [False, True])
def test_step_makes_no_host_sync(run, with_seg):
    """The per-frame path never waits for the device: no .item(),
    boolean-mask indexing, nonzero or host copy inside slam.step or
    slam.step_seg."""
    state, frame, _ = run
    vol = state.volume
    state = state._replace(volume=vol._replace(
        sdf=vol.sdf.clone(), weight=vol.weight.clone(), color=vol.color.clone()),
        votes=labels.LabelVotes(*(x.clone() for x in state.votes)))
    seg = synthetic.gt_segmentation(frame.instance, CFG.instances.max_instances)
    torch.cuda.set_sync_debug_mode("error")
    try:
        if with_seg:
            state, info = slam.step_seg(CFG, state, frame.depth, frame.color, seg)
        else:
            state, info = slam.step(CFG, state, frame.depth, frame.color)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(info.track_ok)


# The photometric term, the sentinel and the stamps on the same geometry.
CFG_RGB = dataclasses.replace(
    CFG, use_instances=False, icp=dataclasses.replace(CFG.icp, rgb_weight=0.1),
    consistency_check=True, track_stamps=True)


@pytest.fixture(scope="module")
def rgb_run():
    """Four photometric frames on the card (textured), and the next frame."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only on the GPU")
    poses = synthetic.orbit_trajectory(12)
    frames = [synthetic.render_frame(poses[i], CFG.intrinsics, texture=True)
              for i in range(5)]
    kernels.reset_launches()
    state = slam.init_state(CFG_RGB, poses[0])
    for f in frames[:4]:
        state, info = slam.step(CFG_RGB, state, f.depth, f.color)
        assert bool(info.track_ok) and not bool(info.drift_alarm)
    launches = {k: (fn.launches, getattr(fn, "launches_rgb", None))
                for k, fn in kernels.wrappers().items()}
    return state, frames[4], launches


def _rgb_inputs(state, frame):
    """Level-0 source maps and intensity of `frame`, the photometric planes
    of the state's prediction, and K2's arguments (without the planes)."""
    args, planes = _level_args(state, frame, 0, intensity=True)
    pyr = preprocess.build_frame_pyramid(frame.depth, CFG.intrinsics, CFG.preprocess, 1,
                                         preprocess.rgb_to_intensity(frame.color))
    return pyr[0], planes, args[3], args


def test_rgb_path_launches(rgb_run):
    """Per frame: K2 and K3 once per association round with the planes,
    plus 3 geometric rounds of the sentinel; K5 with color; no K6."""
    _, _, launches = rgb_run
    rounds = sum(icp.level_schedule(CFG.icp, lvl)[1] for lvl in range(CFG.icp.levels))
    assert launches["K2"] == launches["K3"] == (4 * (rounds + 3), 4 * rounds)
    assert launches["K1"][0] == launches["K4"][0] == launches["K5"][0] == 4
    assert launches["K6"][0] == 0


@pytest.mark.parametrize("lvl", [0, 1, 2])
def test_gather_rgb_kernel_matches_plain(rgb_run, lvl):
    """The fused association with the level's photometric planes,
    bit-identical to its plain version."""
    state, frame, _ = rgb_run
    args, planes = _level_args(state, frame, lvl, intensity=True)
    before = kicp.associate_gather.launches_rgb
    out = kicp.associate_gather(*args, planes)
    ref = kicp.associate_gather_ref(*args, planes)
    assert kicp.associate_gather.launches_rgb == before + 1
    assert int(out.ok.sum()) > 0.3 * out.ok.numel()
    for a, b in zip(out[:4] + out.rgb, ref[:4] + ref.rgb):
        assert torch.equal(a, b)  # bit-identical association


def _gn_rgb_inputs(state, frame):
    """K3's arguments and photometric keywords on the photometric path's
    state: level 0 of `frame` associated with the prediction's planes."""
    src, planes, T_cw, gargs = _rgb_inputs(state, frame)
    q, n_t, ok, _, (i_t, gx_t, gy_t) = kicp.associate_gather(*gargs, planes)
    args = (src["vmap"].reshape(-1, 3).contiguous(), src["nmap"].reshape(-1, 3).contiguous(),
            q, n_t, (src["valid"].reshape(-1) & ok).float(), state.T_wc)
    rgb_kw = dict(rgb=(src["intensity"].reshape(-1).contiguous(), i_t, gx_t, gy_t, ok.float()),
                  T_pred_cw=T_cw, rgb_intr=(CFG.intrinsics.fx, CFG.intrinsics.fy),
                  rgb_weight=0.1)
    return args, rgb_kw


@pytest.mark.parametrize("inner_n", [1, 2, 4, 10])
def test_gn_rgb_kernel_matches_plain(rgb_run, inner_n):
    """Pose within 5e-5 of the plain steps and inliers within 1e-3; the
    trust-fraction weight agrees and is non-zero."""
    state, frame, _ = rgb_run
    args, rgb_kw = _gn_rgb_inputs(state, frame)
    kw = dict(GN_KW, inner_n=inner_n, **rgb_kw)
    T_k, nin_k, _ = kicp.gn_iterations(*args, **kw)
    wr_k = float(kicp.gn_iterations.last_wr)
    T_r, nin_r, _ = kicp.gn_iterations_ref(*args, **kw)
    assert (T_k - T_r).abs().max().item() < 5e-5
    assert abs(float(nin_k) - float(nin_r)) <= 1e-3 * float(nin_r)
    assert wr_k > 0.0


def _gn_case(request, with_rgb):
    """K3's arguments and keywords (4 steps), geometric on the main path's
    state or with the photometric planes on the photometric path's."""
    if with_rgb:
        state, frame, _ = request.getfixturevalue("rgb_run")
        args, rgb_kw = _gn_rgb_inputs(state, frame)
        return args, dict(GN_KW, inner_n=4, **rgb_kw)
    state, frame, _ = request.getfixturevalue("run")
    return _gn_inputs(state, frame), dict(GN_KW, inner_n=4)


@pytest.mark.parametrize("with_rgb", [False, True])
def test_gn_kernel_is_deterministic(request, with_rgb):
    """The same call twice gives the same pose and stats, bit for bit: no
    float atomics, and every block adds the partials in one order."""
    args, kw = _gn_case(request, with_rgb)
    first = kicp.gn_iterations(*args, **kw)
    wr = kicp.gn_iterations.last_wr if with_rgb else None
    second = kicp.gn_iterations(*args, **kw)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    if with_rgb:
        assert torch.equal(wr, kicp.gn_iterations.last_wr)


@pytest.mark.parametrize("with_rgb", [False, True])
def test_gn_kernel_is_one_launch(request, with_rgb):
    """A K3 call is one device launch of gn_kernel, whatever inner_n."""
    from torch.profiler import ProfilerActivity, profile

    args, kw = _gn_case(request, with_rgb)
    kicp.gn_iterations(*args, **kw)
    torch.cuda.synchronize()
    reps = 10
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            kicp.gn_iterations(*args, **kw)
        torch.cuda.synchronize()
    launched = {ev.key: ev.count for ev in prof.key_averages()
                if ev.device_type == torch.autograd.DeviceType.CUDA and ev.count > 0}
    assert len(launched) == 1, launched
    (name, count), = launched.items()
    # The profiler may miss an event at its window's edge, never add one.
    assert "gn_kernel" in name and reps - 1 <= count <= reps, launched


@pytest.mark.parametrize("with_rgb", [False, True])
def test_gn_kernel_replays_in_cuda_graph(request, with_rgb):
    """One K3 call captured in a CUDA graph and replayed gives the eager
    pose and stats: the cooperative launch can be captured."""
    args, kw = _gn_case(request, with_rgb)
    eager = kicp.gn_iterations(*args, **kw)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = kicp.gn_iterations(*args, **kw)
    for x in captured:
        x.fill_(float("nan"))
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(eager, captured):
        assert torch.equal(a, b)


def _ne_inputs(rgb_run):
    """K6's p_w, n_t, q_w and mask at level 0 of the photometric path's
    next frame, associated with its prediction."""
    state, frame, _ = rgb_run
    src, _, _, gargs = _rgb_inputs(state, frame)
    q, n_t, ok, _, _ = kicp.associate_gather(*gargs)
    p_w = (src["vmap"].reshape(-1, 3) @ state.T_wc[:3, :3].T + state.T_wc[:3, 3]).contiguous()
    mask = (src["valid"].reshape(-1) & ok & ((p_w - q).norm(dim=-1) < 0.1)).float()
    return p_w, n_t, q, mask


def _assert_ne_close(out, ref):
    """H and b within rtol/atol 2e-3 (another summation order), inliers
    exact, residual sum within rtol 1e-3."""
    for a, b in zip(out[:2], ref[:2]):
        torch.testing.assert_close(a, b, rtol=2e-3, atol=2e-3)
    assert float(out[2]) == float(ref[2])
    torch.testing.assert_close(out[3], ref[3], rtol=1e-3, atol=0.0)


@pytest.mark.parametrize("huber_delta", [0.0, 0.02])
def test_normal_equations_kernel_matches_plain(rgb_run, huber_delta):
    """H and b within rtol/atol 2e-3 (another summation order), inliers
    exact, residual sum within rtol 1e-3."""
    p_w, n_t, q, mask = _ne_inputs(rgb_run)
    before = kicp.normal_equations.launches
    out = kicp.normal_equations(p_w, n_t, q, mask, huber_delta)
    ref = kicp.normal_equations_ref(p_w, n_t, q, mask, huber_delta)
    assert kicp.normal_equations.launches == before + 1
    assert float(ref[2]) > 5000
    _assert_ne_close(out, ref)


def test_normal_equations_kernel_is_one_launch(rgb_run):
    """A K6 call is one device launch of ne_kernel and no other device op:
    the last block to finish adds the partials."""
    p_w, n_t, q, mask = _ne_inputs(rgb_run)
    _assert_one_launch(_device_ops(lambda: kicp.normal_equations(p_w, n_t, q, mask, 0.02)),
                       "ne_kernel")


def test_normal_equations_kernel_repeats_bit_for_bit(rgb_run):
    """Two calls give the same bits: the ticket picks the block that adds
    the rows, never their order, and is back at 0 after a call."""
    p_w, n_t, q, mask = _ne_inputs(rgb_run)
    first = kicp.normal_equations(p_w, n_t, q, mask, 0.02)
    second = kicp.normal_equations(p_w, n_t, q, mask, 0.02)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    _assert_ne_close(first, kicp.normal_equations_ref(p_w, n_t, q, mask, 0.02))


def test_normal_equations_kernel_replays_in_cuda_graph(rgb_run):
    """One K6 call captured in a CUDA graph and replayed, and an eager call
    after the replay, equal the first eager call bit for bit: each launch
    leaves the ticket at 0."""
    p_w, n_t, q, mask = _ne_inputs(rgb_run)
    eager = kicp.normal_equations(p_w, n_t, q, mask, 0.02)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = kicp.normal_equations(p_w, n_t, q, mask, 0.02)
    for x in captured:
        x.fill_(float("nan"))
    graph.replay()
    after = kicp.normal_equations(p_w, n_t, q, mask, 0.02)
    torch.cuda.synchronize()
    for a, b, c in zip(eager, captured, after):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("n", [1, 300, 5000])
def test_normal_equations_kernel_small_n(rgb_run, n):
    """N = 1 and N below the grid's threads (one block a 256 pixels): the
    plain version's sums within its tolerances."""
    p_w, n_t, q, mask = (x[:n].contiguous() for x in _ne_inputs(rgb_run))
    mask[0] = 1.0
    _assert_ne_close(kicp.normal_equations(p_w, n_t, q, mask, 0.02),
                     kicp.normal_equations_ref(p_w, n_t, q, mask, 0.02))


def test_plain_versions_launch_nothing(rgb_run):
    """The *_ref functions stay plain on CUDA tensors: no count moves."""
    state, frame, _ = rgb_run
    src, planes, T_cw, gargs = _rgb_inputs(state, frame)
    counts = {k: fn.launches for k, fn in kernels.wrappers().items()}
    q, n_t, ok, _, (i_t, gx_t, gy_t) = kicp.associate_gather_ref(*gargs, planes)
    kicp.gn_iterations_ref(
        src["vmap"].reshape(-1, 3), src["nmap"].reshape(-1, 3), q, n_t, ok.float(),
        state.T_wc, inner_n=2, dist_thresh=0.1, angle_thresh=0.34, huber_delta=0.0,
        damping=1e-6, min_valid=60,
        rgb=(src["intensity"].reshape(-1), i_t, gx_t, gy_t, ok.float()),
        T_pred_cw=T_cw, rgb_intr=(CFG.intrinsics.fx, CFG.intrinsics.fy), rgb_weight=0.1)
    kicp.normal_equations_ref(q, n_t, q, ok.float(), 0.0)
    vol = state.volume
    slots, valid = blocks.frustum_slots(vol, state.T_wc, CFG.intrinsics, CFG.tsdf, 0.2, 4.0, K)
    psi, w_obs, obs = blocks.touched_observations(vol, slots, valid, frame.depth, frame.color,
                                                  frame.T_wc, CFG.intrinsics, CFG.tsdf)
    ktsdf.tsdf_update_ref(vol.sdf.clone(), vol.weight.clone(), vol.color.clone(), slots,
                          valid, psi, w_obs, obs, CFG.tsdf.max_weight)
    torch.cuda.synchronize()
    assert counts == {k: fn.launches for k, fn in kernels.wrappers().items()}


def test_rgb_step_makes_no_host_sync(rgb_run):
    """The photometric term, the sentinel and the stamps stay on the device."""
    state, frame, _ = rgb_run
    vol = state.volume
    state = state._replace(volume=vol._replace(
        sdf=vol.sdf.clone(), weight=vol.weight.clone(), color=vol.color.clone()))
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, info = slam.step(CFG_RGB, state, frame.depth, frame.color)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(info.track_ok) and not bool(info.drift_alarm)
    assert int(state.stamp[:, 0].max()) == int(state.frame_idx)


# The block map without splat prediction (the touched-block integrate with
# K8, then the marched raycast) and the dense volume, at the same scale.
CFG_MARCH = dataclasses.replace(CFG, use_instances=False,
                                raycast=dataclasses.replace(CFG.raycast, use_splat=False))
CFG_DENSE = dataclasses.replace(
    CFG_MARCH, map_kind="dense",
    tsdf=TsdfConfig(voxel_size=0.04, trunc=0.12, grid_size=96, origin=(-1.92, -1.92, -0.4)))


@pytest.fixture(scope="module")
def march_run():
    """Four frames of the march path on the card, and the next frame."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only on the GPU")
    poses = synthetic.orbit_trajectory(12)
    frames = [synthetic.render_frame(poses[i], CFG.intrinsics) for i in range(5)]
    kernels.reset_launches()
    state = slam.init_state(CFG_MARCH, poses[0])
    for f in frames[:4]:
        state, info = slam.step(CFG_MARCH, state, f.depth, f.color)
        assert bool(info.track_ok)
    launches = {k: fn.launches for k, fn in kernels.wrappers().items()}
    return state, frames[4], launches, poses


def test_march_path_launches(march_run):
    """K8 once a frame; K4 and K5 (the splat path's) never."""
    _, _, launches, _ = march_run
    rounds = sum(icp.level_schedule(CFG.icp, lvl)[1] for lvl in range(CFG.icp.levels))
    assert launches == {"K1": 4, "K2": 4 * rounds, "K3": 4 * rounds, "K4": 0,
                        "K5": 0, "K6": 0, "K7": 0, "K8": 4}


def _update_case(march_run, with_color):
    """The next frame's touched list on the march path's state: the map,
    K8's arguments and the listed rows."""
    state, frame, _, _ = march_run
    touched = blocks.touched_blocks_mask(frame.depth, frame.T_wc, CFG.intrinsics, CFG.tsdf)
    vol = blocks.allocate_touched(state.volume, touched, CFG.tsdf)
    slots, valid = blocks.compact_touched_slots(vol, touched, CFG.tsdf,
                                                CFG.tsdf.touched_capacity)
    psi, w_obs, obs = blocks.touched_observations(
        vol, slots, valid, frame.depth, frame.color if with_color else None, frame.T_wc,
        CFG.intrinsics, CFG.tsdf)
    return vol, (slots, valid, psi, w_obs, obs, CFG.tsdf.max_weight), slots[valid].long()


@pytest.mark.parametrize("with_color", [True, False])
def test_tsdf_update_kernel_matches_plain(march_run, with_color):
    """On the next frame's touched list: sdf, weight and color bit-equal to
    the plain version on every voxel; every other row, and color without
    color, untouched."""
    vol, args, rows = _update_case(march_run, with_color)
    before = [x.clone() for x in (vol.sdf, vol.weight, vol.color)]
    maps_k = [x.clone() for x in before]
    maps_r = [x.clone() for x in before]
    launches = ktsdf.tsdf_update.launches
    ktsdf.tsdf_update(*maps_k, *args)
    ktsdf.tsdf_update_ref(*maps_r, *args)
    assert ktsdf.tsdf_update.launches == launches + 1
    assert rows.numel() > 50 and not torch.equal(maps_k[1], before[1])
    for out_k, out_r, b in zip(maps_k, maps_r, before):
        _assert_bit_equal(out_k, out_r, b, rows)
    if not with_color:
        assert torch.equal(maps_k[2], before[2])


@pytest.mark.parametrize("with_color", [True, False])
@pytest.mark.parametrize("kind", LISTS)
def test_tsdf_update_kernel_matches_plain_on_random_rows(with_color, kind):
    """Rows made from a seed, weights fractional over (0, 70) beside 0 and
    the clamp, w_obs 0, 1 and fractional, color gain 4: bit-equal to the
    plain version, so the kernel's __frcp_rn equals PyTorch's reciprocal,
    on each list shape; rows outside the valid set stay untouched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only on the GPU")
    rng = np.random.default_rng(12)
    c, k = 300, 200
    weight = rng.uniform(0.0, 70.0, (c, 512)).astype(np.float32)
    weight[:, :64] = 0.0
    weight[:, 64:128] = 64.0
    slots = torch.from_numpy(rng.permutation(c)[:k].astype(np.int32)).cuda()
    valid = torch.from_numpy(rng.random(k) < 0.6).cuda()
    slots, valid = _relist(slots, valid, kind)
    k = slots.numel()
    w_obs = rng.choice(np.float32([0.0, 0.0, 1.0, 0.37]), (k, 512))
    planes = [torch.from_numpy(x).cuda() for x in (
        rng.uniform(-1, 1, (c, 512)).astype(np.float32), weight,
        rng.uniform(0, 1, (c, 1536)).astype(np.float32))]
    obs = torch.from_numpy(rng.uniform(0, 1, (k, 1536)).astype(np.float32)).cuda()
    args = (slots, valid, torch.from_numpy(rng.uniform(-1, 1, (k, 512)).astype(np.float32)).cuda(),
            torch.from_numpy(w_obs).cuda(), obs if with_color else None, 64.0, 4.0)
    maps_k = [x.clone() for x in planes]
    maps_r = [x.clone() for x in planes]
    ktsdf.tsdf_update(*maps_k, *args)
    ktsdf.tsdf_update_ref(*maps_r, *args)
    for out_k, out_r, b in zip(maps_k, maps_r, planes):
        _assert_bit_equal(out_k, out_r, b, slots[valid].long())


@pytest.mark.parametrize("with_color", [True, False])
def test_tsdf_update_kernel_is_one_launch(march_run, with_color):
    """A K8 call is one device launch of tsdf_update_kernel and no other
    device op."""
    vol, args, _ = _update_case(march_run, with_color)
    maps = [x.clone() for x in (vol.sdf, vol.weight, vol.color)]
    _assert_one_launch(_device_ops(lambda: ktsdf.tsdf_update(*maps, *args)),
                       "tsdf_update_kernel")


@pytest.mark.parametrize("with_color", [True, False])
def test_tsdf_update_kernel_repeats_bit_for_bit(march_run, with_color):
    """Two calls on clones of the same planes leave them bit-equal."""
    vol, args, _ = _update_case(march_run, with_color)
    first = [x.clone() for x in (vol.sdf, vol.weight, vol.color)]
    second = [x.clone() for x in first]
    ktsdf.tsdf_update(*first, *args)
    ktsdf.tsdf_update(*second, *args)
    for a, b in zip(first, second):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("with_color", [True, False])
def test_tsdf_update_kernel_replays_in_cuda_graph(march_run, with_color):
    """One K8 call captured in a CUDA graph and replayed updates as the
    eager call does."""
    vol, args, _ = _update_case(march_run, with_color)
    _replay_equals_eager(lambda m: ktsdf.tsdf_update(*m, *args),
                         [vol.sdf, vol.weight, vol.color])


@pytest.mark.parametrize("kind", ["march", "dense"])
def test_march_and_dense_steps_make_no_host_sync(march_run, kind):
    """The march path and the dense path never wait for the device."""
    state, frame, _, poses = march_run
    cfg = CFG_MARCH
    if kind == "dense":
        cfg = CFG_DENSE
        state = slam.init_state(cfg, poses[0])
        for i in range(4):
            f = synthetic.render_frame(poses[i], cfg.intrinsics)
            state, _ = slam.step(cfg, state, f.depth, f.color)
    else:
        vol = state.volume
        state = state._replace(volume=vol._replace(
            sdf=vol.sdf.clone(), weight=vol.weight.clone(), color=vol.color.clone()))
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, info = slam.step(cfg, state, frame.depth, frame.color)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(info.track_ok) and int(state.pred.valid.sum()) > 3000
