"""Data- and tensor-parallel segmentation (``models/parallel.py``) on 4 gloo
ranks on the CPU, held to the one-rank ``segment`` as the reference's
tests/test_shard.py holds its DP and TP forms: 48x64 frames, 8 classes,
K 8, width 16, the reference's flax initial parameters."""

import jax
import numpy as np
import pytest
import torch

from instancefusion_tpu.models import segmentation as jseg
from instancefusion_tpu_torch import convert
from instancefusion_tpu_torch.models import segmentation as pseg
from instancefusion_tpu_torch.parallel import mesh
from tests import torch_shard_workers as workers
from tests.torch_helpers import one_thread  # noqa: F401 (autouse fixture)

S, H, W, NC, K, WIDTH = 4, 48, 64, 8, 8, 16


@pytest.fixture(scope="module")
def setup():
    params = jax.jit(jseg.init_params, static_argnums=(1, 2, 3, 4))(
        jax.random.PRNGKey(0), H, W, NC, WIDTH)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    state = {k: v.numpy() for k, v in convert.seghead_from_flax(
        {jax.tree_util.keystr(kp): np.asarray(x) for kp, x in flat}).items()}
    rgb = np.random.default_rng(1).uniform(size=(S, H, W, 3)).astype(np.float32)
    model = workers._head(state, NC, WIDTH)
    single = [pseg.segment(model, torch.from_numpy(x), K) for x in rgb]
    with mesh.RankPool(S, device="cpu") as pool:
        dp = pool.run(workers.dp_segment, state, NC, WIDTH, rgb, K)
        tp = pool.run(workers.tp_segment, state, NC, WIDTH, rgb[0], K)
    return single, dp, tp


def test_dp_segment_matches_one_rank(setup):
    single, dp, _ = setup
    for out in dp:  # every rank holds the whole batch
        for i, ref in enumerate(single):
            np.testing.assert_array_equal(out["mask_id"][i], ref.mask_id.numpy())
            np.testing.assert_array_equal(out["classes"][i], ref.classes.numpy())
            np.testing.assert_array_equal(out["valid"][i], ref.valid.numpy())
            np.testing.assert_array_equal(out["scores"][i], ref.scores.numpy())


def test_tp_segment_matches_one_rank(setup):
    single, _, tp = setup
    ref = single[0]
    assert int(ref.valid.sum()) > 0
    for out, split, kept in tp:
        np.testing.assert_array_equal(out["mask_id"], ref.mask_id.numpy())
        np.testing.assert_array_equal(out["classes"], ref.classes.numpy())
        np.testing.assert_allclose(out["scores"], ref.scores.numpy(), rtol=0, atol=1e-4)
        # The reference's rule: every conv weight with Cout % S == 0 and
        # Cout >= S splits (the 8 blocks' 3x3 convs and the 8-class output
        # conv); the center (1) and offset (2) convs, biases and norms do not.
        assert {n for n, d in split.items() if d == 0} == (
            {f"blocks.{i}.conv.weight" for i in range(8)} | {"sem.weight"})
        assert kept["blocks.3.conv.weight"] == (8 * WIDTH // S, 4 * WIDTH, 3, 3)
        assert kept["blocks.3.conv.bias"] == (8 * WIDTH // S,)
        assert kept["center.weight"] == (1, WIDTH, 1, 1)


def test_dp_rejects_a_batch_that_does_not_split():
    from instancefusion_tpu_torch.models import parallel

    group = mesh.ShardGroup(0, 3, torch.device("cpu"))
    fn = parallel.dp_segment_fn(group, K)
    with pytest.raises(ValueError, match="divisible"):
        fn(pseg.PanopticHead(NC, WIDTH), torch.zeros(4, H, W, 3))
