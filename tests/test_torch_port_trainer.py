"""The port's training loop on the CPU: the loader against the JAX
package's (the same batches in the same order, bit for bit), the configs
against JAX's load_config, `cli.train.main` with a checkpoint, a resume
that continues the uninterrupted run bit for bit (under
torch.use_deterministic_algorithms), `cli.generate.main` on the run's log
dir with --ckpt_iter and --ema, the weights both ways across the flax
naming, a port-trained module read by the JAX package's reference
importer (its forward to the module path's 2e-4), and the refusals at the
slice's edge (--num_devices beyond the machine's cards, an unconverted
JAX orbax log dir; a bf16 config trains)."""

import dataclasses
import glob
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from agdiff_tpu.config import load_config as jax_load_config
from agdiff_tpu.config import config_from_json as jax_config_from_json
from agdiff_tpu.data.dataset import (
    BucketedLoader as JaxLoader,
    ConformationDataset as JaxDataset,
)
from agdiff_tpu.models.dualenc import get_model as jax_get_model
from agdiff_tpu.train.import_torch import (
    load_reference_checkpoint as jax_load_reference,
)

from agdiff_torch.cli import generate as gen_cli
from agdiff_torch.cli import train as train_cli
from agdiff_torch.cli._common import load_inference_bundle
from agdiff_torch.config import config_to_json, load_config
from agdiff_torch.data.dataset import BucketedLoader, ConformationDataset
from agdiff_torch.eval.generate import load_samples
from agdiff_torch.models.dualenc import DualEncoderEpsNetwork
from agdiff_torch.models.reference_checkpoint import (
    export_reference_state_dict,
)
from agdiff_torch.models.weights import (
    export_jax_variables,
    init_like_jax,
    load_jax_variables,
)
from agdiff_torch.train.checkpoint import load_checkpoint

from test_torch_port_common import (
    SMALL,
    batches,
    configs,
    jax_run,
    molecules,
    port_molecule,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTH = ["--synthetic", "16", "--synthetic_heavy", "5", "--device", "cpu"]
SCORE_ATOL = 2e-4


def _write_config(path, **train):
    raw = {"model": dict(SMALL),
           "train": {"seed": 3, "batch_size": 4, "val_freq": 3,
                     "max_iters": 6, "ema_decay": 0.9, **train},
           "buckets": {"max_nodes": [16]}}
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return str(path)


def test_loader_batches_equal_jax():
    """One seed: the same buckets and batches, bit for bit, in the same
    order, from the shuffled stream and from the validation pass."""
    mols = molecules(14, seed=2)
    buckets = (12, 16, 24)
    want = JaxLoader(JaxDataset(mols), 4, buckets, seed=11)
    got = BucketedLoader(ConformationDataset([port_molecule(m)
                                              for m in mols]), 4, buckets,
                         seed=11)
    assert got.bucket_sizes == want.bucket_sizes and len(got.groups) > 1
    fields = ("atom_type", "pos", "node_mask", "bond_adj", "graph_mask")
    for (bw, jb), (bg, tb) in zip(
            [next(iter(want)) for _ in range(9)],
            [got.next_batch() for _ in range(9)]):
        assert bw == bg
        for f in fields:
            assert np.array_equal(getattr(tb, f).numpy(),
                                  np.asarray(getattr(jb, f))), f
    val_w = JaxLoader(JaxDataset(mols), 4, buckets, shuffle=False,
                      drop_last=False)
    val_g = BucketedLoader(ConformationDataset([port_molecule(m)
                                                for m in mols]), 4, buckets,
                           shuffle=False, drop_last=False)
    pairs = list(zip(val_w.epoch_batches(), val_g.epoch_batches()))
    assert len(pairs) == len(list(val_w.epoch_batches()))
    for (bw, jb), (bg, tb) in pairs:
        assert bw == bg
        assert np.array_equal(tb.pos.numpy(), np.asarray(jb.pos))


def test_loader_state_continues_the_draws():
    mols = [port_molecule(m) for m in molecules(10, seed=2)]
    a = BucketedLoader(ConformationDataset(mols), 3, (12, 16, 24), seed=4)
    for _ in range(5):
        a.next_batch()
    state = a.state_dict()
    rest = [a.next_batch() for _ in range(6)]
    b = BucketedLoader(ConformationDataset(mols), 3, (12, 16, 24), seed=99)
    b.load_state_dict(state)
    for (ba, xa), (bb, xb) in zip(rest, [b.next_batch() for _ in range(6)]):
        assert ba == bb and torch.equal(xa.pos, xb.pos)


@pytest.mark.parametrize("name", sorted(
    os.path.basename(p) for p in glob.glob(os.path.join(ROOT, "configs",
                                                        "*.yml"))))
def test_configs_load_like_jax(name):
    path = os.path.join(ROOT, "configs", name)
    got, want = load_config(path), jax_load_config(path)
    g, w = dataclasses.asdict(got), dataclasses.asdict(want)
    assert tuple(g.pop("buckets")) == tuple(w.pop("buckets")["max_nodes"])
    assert g == w
    # a config written by the port is read by the JAX package
    assert dataclasses.asdict(jax_config_from_json(config_to_json(got))) \
        == dataclasses.asdict(want)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """An uninterrupted 6-iteration run (checkpoints 3 and 6) and a copy
    resumed from checkpoint 3, both through cli.train.main --deterministic
    on the CPU."""
    root = tmp_path_factory.mktemp("train")
    cfg = _write_config(root / "small.yml")
    try:
        full = train_cli.main([cfg, "--logdir", str(root / "logs"),
                               "--deterministic", *SYNTH])
        resumed_dir = str(root / "resumed")
        shutil.copytree(full.log_dir, resumed_dir)
        shutil.rmtree(os.path.join(resumed_dir, "checkpoints", "6"))
        resumed = train_cli.main([resumed_dir, "--resume_iter", "3",
                                  "--deterministic", *SYNTH])
    finally:
        torch.use_deterministic_algorithms(False)
    return root, full, resumed


def test_cli_trains_and_checkpoints(runs):
    _, full, _ = runs
    d = full.log_dir
    assert sorted(os.listdir(os.path.join(d, "checkpoints"))) == ["3", "6"]
    assert os.path.exists(os.path.join(d, "best_model", "POINTER"))
    assert os.path.exists(os.path.join(d, "config.yml"))
    assert len(full.losses) == 6 and np.isfinite(full.losses).all()
    ckpt = load_checkpoint(os.path.join(d, "checkpoints", "6"))
    assert ckpt["step"] == 6 and ckpt["iteration"] == 6
    assert ckpt["config"].train.ema_decay == 0.9
    assert set(ckpt["ema"]) == {n for n, _ in
                                full.state.module.named_parameters()}


def test_resume_continues_bit_for_bit(runs):
    """Iterations 4-6 after a resume from checkpoint 3 equal those of the
    uninterrupted run: parameters, running statistics, both Adams, the
    EMA shadow, the step generator and the loader."""
    _, full, resumed = runs
    a = load_checkpoint(os.path.join(full.log_dir, "checkpoints", "6"))
    b = load_checkpoint(os.path.join(resumed.log_dir, "checkpoints", "6"))
    assert resumed.losses == full.losses[3:]
    for key in a["module"]:
        assert torch.equal(a["module"][key], b["module"][key]), key
    for key in a["ema"]:
        assert torch.equal(a["ema"][key], b["ema"][key]), key
    for part in ("global", "local"):
        oa, ob = a["optimizer"]["adams"][part], b["optimizer"]["adams"][part]
        assert oa["count"] == ob["count"] == 6
        for x, y in zip(oa["mu"] + oa["nu"], ob["mu"] + ob["nu"]):
            assert torch.equal(x, y)
    assert torch.equal(a["generator"], b["generator"])
    assert a["loader"]["cursor"] == b["loader"]["cursor"]
    assert a["loader"]["rng"] == b["loader"]["rng"]
    assert a["plateau_global"] == b["plateau_global"]


def test_generate_reads_the_log_dir_with_ema(runs):
    root, full, _ = runs
    out = root / "samples"
    gen_cli.main([full.log_dir, "--ckpt_iter", "3", "--ema", "--synthetic",
                  "2", "--synthetic_heavy", "4", "--n_steps", "3",
                  "--end_idx", "2", "--out_dir", str(out), "--device",
                  "cpu"])
    got = load_samples(str(out / "samples_all.npz"))
    assert len(got) == 2
    assert all(np.isfinite(m.meta["pos_gen"]).all() for m in got)
    # --ema: the shadow's parameters, the raw running statistics
    ckpt = load_checkpoint(os.path.join(full.log_dir, "checkpoints", "3"))
    _, model, path, it = load_inference_bundle(full.log_dir, 3,
                                               use_ema=True)
    assert it == 3 and path.endswith(os.path.join("checkpoints", "3"))
    for name, p in model.named_parameters():
        assert torch.equal(p, ckpt["ema"][name]), name
    for name, buf in model.named_buffers():
        assert torch.equal(buf, ckpt["module"][name]), name
    assert not all(torch.equal(ckpt["ema"][n], ckpt["module"][n])
                   for n in ckpt["ema"])
    _, raw, _, it = load_inference_bundle(full.log_dir)
    assert it == 6


def test_export_then_load_is_the_identity():
    _, cfg = configs(tie_edge_encoders=False)
    a = init_like_jax(DualEncoderEpsNetwork(cfg),
                      torch.Generator().manual_seed(1))
    with torch.no_grad():
        for buf in a.buffers():
            buf.uniform_(0.5, 1.5)
    b = DualEncoderEpsNetwork(cfg)
    load_jax_variables(b, export_jax_variables(a))
    sa, sb = a.state_dict(), b.state_dict()
    assert set(sa) == set(sb)
    for key in sa:
        assert torch.equal(sa[key], sb[key]), key


def test_init_like_jax_draws_the_jax_distributions():
    _, cfg = configs(hidden_dim=64)
    m = init_like_jax(DualEncoderEpsNetwork(cfg),
                      torch.Generator().manual_seed(0)).requires_grad_(False)
    conv = m.encoder_global.interactions_0.conv1
    for lin in (conv.filter_0, conv.filter_1, conv.lin1, conv.lin2):
        fan_out, fan_in = lin.weight.shape
        bound = np.sqrt(6.0 / (fan_in + fan_out))
        assert float(lin.weight.abs().max()) <= bound
        assert float(lin.weight.abs().max()) > 0.9 * bound
        assert not lin.bias.any()
    lin = m.grad_global_dist_mlp.layers_0
    bound = 1.0 / np.sqrt(lin.in_features)
    assert 0.9 * bound < float(lin.weight.abs().max()) <= bound
    assert 0.9 * bound < float(lin.bias.abs().max()) <= bound
    emb = m.encoder_local.node_emb.weight
    assert abs(float(emb.std()) - 1.0) < 0.05
    bn = m.encoder_local.batch_norms_0
    assert bool((bn.weight == 1).all() and (bn.running_var == 1).all())
    again = init_like_jax(DualEncoderEpsNetwork(cfg),
                          torch.Generator().manual_seed(0))
    assert all(torch.equal(x, y) for x, y in zip(m.state_dict().values(),
                                                 again.state_dict().values()))


def test_port_trained_module_runs_in_jax(runs, tmp_path):
    """A module the port trained, exported as a reference .pt, is read by
    the JAX package's importer; JAX's forward on it equals the port's to
    the module path's 2e-4."""
    _, full, _ = runs
    model = full.state.module.cpu().eval()
    ckpt = str(tmp_path / "trained.pt")
    torch.save({"model": export_reference_state_dict(model),
                "config": {"model": dict(SMALL)}}, ckpt)
    variables, jcfg = jax_load_reference(ckpt)
    jb, tb = batches(molecules(2, seed=6), 16)
    want = jax_run(lambda v, b: jax_get_model(jcfg).apply(v, b, train=False),
                   variables, jb)
    with torch.no_grad():
        got = model(tb)
    for name, mask in (("edge_inv_global", "edge_mask"),
                       ("edge_inv_local", "local_mask")):
        m = np.asarray(getattr(want, mask))
        np.testing.assert_allclose(
            np.where(m, getattr(got, name).numpy(), 0),
            np.where(m, np.asarray(getattr(want, name)), 0),
            atol=SCORE_ATOL, err_msg=name)
    assert float(jnp.abs(want.edge_inv_global).max()) > 1e-3


def test_refusals_name_their_roadmap_items(tmp_path):
    """--num_devices beyond the machine's cards (item 7 trains
    data-parallel since it was ported; tests/test_torch_port_parallel_
    cli.py runs it) and an unconverted JAX orbax log dir (item 4c, ported:
    the message names convert_jax_checkpoint.py) raise; a bf16 config
    (item 4a, refused before bf16 training was ported) trains at bf16
    compute."""
    bf16 = _write_config(tmp_path / "bf16.yml")
    raw = yaml.safe_load(open(bf16))
    raw["model"]["dtype"] = "bfloat16"
    yaml.safe_dump(raw, open(bf16, "w"))
    trainer = train_cli.main([bf16, "--logdir", str(tmp_path / "l"), *SYNTH])
    assert trainer.state.module.compute_dtype == torch.bfloat16
    assert len(trainer.losses) == 6 and np.isfinite(trainer.losses).all()
    too_many = (torch.cuda.device_count() if torch.cuda.is_available()
                else 0) + 1
    with pytest.raises(ValueError, match=f"requested {too_many} devices"):
        train_cli.main([bf16, "--num_devices", str(too_many),
                        *SYNTH[:-2]])
    # a JAX log dir: checkpoints/<it>/state is an orbax directory
    jax_dir = tmp_path / "jax_run"
    os.makedirs(jax_dir / "checkpoints" / "5" / "state")
    shutil.copy(_write_config(tmp_path / "ok.yml"), jax_dir / "config.yml")
    with pytest.raises(FileNotFoundError, match="convert_jax_checkpoint.py"):
        train_cli.main([str(jax_dir), *SYNTH])
    with pytest.raises(FileNotFoundError, match="convert_jax_checkpoint.py"):
        load_inference_bundle(str(jax_dir))
    with pytest.raises(FileNotFoundError, match="convert_jax_checkpoint.py"):
        gen_cli.main([str(jax_dir), "--synthetic", "1", "--device", "cpu"])
