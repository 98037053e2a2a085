"""The port's config engine (`sgdm_tpu_torch/config/engine.py`) against the
JAX package's (`sgdm_tpu/config/engine.py`), on the repo's `configs/`.

  * `compose` equals the JAX engine's on several override sets (group
    choices, value overrides, ``+`` and ``~``): exactly (the targets keep
    their ``sgdm_tpu.`` prefix; `get_obj_from_str` reads it as the port's);
  * a config written unresolved (`--save-config`) and loaded with value
    overrides equals composing with them;
  * override values parse alike with PyYAML and without it (JSON, then the
    bare string) for every value the README, the tests and `chip_smoke.py`
    pass, and a JSON config loads without PyYAML;
  * the committed `sgdm_tpu_torch/configs/fit_in64_synthetic.json` equals
    its recomposition, and resolves as the JAX engine composes it;
  * the committed `sgdm_tpu_torch/configs/fit_in64p_cluster5000.json` (the
    README's IN64 self-labeled headline run) equals its recomposition, and
    so do `fit_voc64_lost.json` and `fit_coco64_stego.json` (the README's
    VOC64 self-boxed and COCO-Stuff64 self-segmented runs), which resolve
    as the JAX engine composes them;
  * the data configs the port reads resolve to its classes, and targets
    the port lacks raise ImportError naming the ROADMAP item.
"""

import json
import sys
from pathlib import Path

import pytest

from sgdm_tpu.config.engine import compose as jax_compose
from sgdm_tpu.config.engine import to_container as jax_to_container
from sgdm_tpu_torch.config.engine import (compose, compose_unresolved, get_obj_from_str,
                                          load_config, parse_value, save_config, to_container)

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = ROOT / "configs"
FIT_JSON = ROOT / "sgdm_tpu_torch" / "configs" / "fit_in64_synthetic.json"
IN64P_JSON = ROOT / "sgdm_tpu_torch" / "configs" / "fit_in64p_cluster5000.json"
# README.md's VOC64 self-boxed (LOST) and COCO-Stuff64 self-segmented (STEGO)
# commands (data.h5_file, data.lost_file, data.stego_dir given at load time)
SEG_RUNS = {
    "fit_voc64_lost": ["data=voc64", "dynamic=unetca_fast", "sg.params.condition_method=clusterlayout",
                       "condition.clusterlayout.how=lost", "sg.params.cond_dim=100",
                       "dynamic.params.cond_token_num=1", "dynamic.params.context_dim=32",
                       "sg.params.cond_drop_prob=0.1", "sg.params.cond_scale=2", "name=voc64_lost"],
    "fit_coco64_stego": ["data=cocostuff64", "dynamic=unetca_fast",
                         "sg.params.condition_method=stegoclusterlayout",
                         "dynamic.params.cond_token_num=1", "dynamic.params.context_dim=32",
                         "sg.params.cond_drop_prob=0.1", "sg.params.cond_scale=2",
                         "name=coco64_stego"],
}
SEG_LOAD = {"fit_voc64_lost": ["data.h5_file=/srv/voc/cluster100.h5", "data.lost_file=/srv/voc/lost.h5",
                               "data.root=/srv/voc12"],
            "fit_coco64_stego": ["data.stego_dir=/srv/stego", "data.root=/srv/cocostuff"]}
# README.md's IN64 self-labeled headline command (data.h5_file given at load time)
IN64P_OVERRIDES = [
    "data=in64_pickle", "dynamic=unet_fast", "sg.params.condition_method=cluster",
    "sg.params.cond_dim=5000", "sg.params.cond_drop_prob=0.1", "sg.params.cond_scale=2",
    "name=in64_cluster5000",
]
# the overrides the committed fit config was composed with (README, chip_smoke `fit`)
FIT_OVERRIDES = [
    "data=synthetic32", "dynamic=unet_fast", "data.image_size=64", "data.num_classes=1000",
    "+data.params.train.params.cond_key=cluster", "+data.params.validation.params.cond_key=cluster",
    "sg.params.condition_method=cluster", "sg.params.cond_dim=1000", "sg.params.cond_drop_prob=0.1",
    "sg.params.cond_scale=2", "data.params.batch_size=128", "pl.trainer.limit_train_batches=4",
    "pl.trainer.limit_val_batches=2", "data.vis_every_iter=4",
    "model.params.num_timesteps_imagelogger=50", "pl.trainer.log_every_n_steps=2",
    "name=fit_in64_synthetic",
]
OVERRIDE_SETS = {
    "synthetic32": ["data=synthetic32"],
    "in64-cluster": ["data=in64_pickle", "dynamic=unet_fast", "sg.params.condition_method=cluster",
                     "sg.params.cond_dim=5000", "sg.params.cond_drop_prob=0.1",
                     "sg.params.cond_scale=2", "data.params.batch_size=256", "name=in64_cluster"],
    "voc64-unetca": ["data=voc64", "dynamic=unetca_fast",
                     "sg.params.condition_method=stegoclusterlayout", "sg.params.cond_dim=21",
                     "dynamic.params.cond_token_num=1", "dynamic.params.context_dim=32",
                     "condition.stegoclusterlayout.layout_dim=21"],
    "add-delete": ["data=synthetic32", "+vis.chainvis=1", "~vis.interp_c",
                   "+data.params.train.params.cond_key=cluster", "debug=true",
                   "dynamic.params.channel_mult=[1,2]", "optim=adam"],
    "fit": FIT_OVERRIDES,
    "in64p": IN64P_OVERRIDES,
    **SEG_RUNS,
}
# every override value the README, the tests and chip_smoke.py pass (the
# part after '='), parsed with and without PyYAML
VALUES_USED = sorted({ov.split("=", 1)[1] for ovs in OVERRIDE_SETS.values() for ov in ovs
                      if "=" in ov} | {
    "1", "2", "0", "3", "8", "16", "32", "0.5", "1000", "10", "4", "true", "false", "null",
    "[1,2]", "[2]", "[1, 2]", "cpu", "outputs/run1/ckpts/last", "/tmp/x/ckpts/last",
    "build/fit/straight", "/srv/runs/fit/resumed/ckpts/last", "label", "cluster", "run1",
    "outputs/tiny", "outputs/fit", "0.1", "1000000000", "0.5", "float32",
    # the FID runs: README, chip_smoke `fid`, tests/test_torch_harness.py
    "256", "128", "50", "[]", "[1]", "outputs/ref", "outputs/fit/ckpts/last",
    "/srv/runs/fid/ref", "/srv/runs/fid/run/ckpts/last"})


@pytest.mark.parametrize("name", list(OVERRIDE_SETS))
def test_compose_equals_the_jax_engine(name):
    ovs = OVERRIDE_SETS[name]
    assert to_container(compose(CONFIGS, overrides=ovs)) == \
        jax_to_container(jax_compose(CONFIGS, overrides=ovs))


@pytest.mark.parametrize("name", ["synthetic32", "in64-cluster", "add-delete"])
def test_json_round_trip_takes_overrides_as_compose_does(name, tmp_path):
    path = tmp_path / "c.json"
    save_config(compose_unresolved(CONFIGS, overrides=OVERRIDE_SETS[name]), path)
    extra = ["data.params.batch_size=4", "sg.params.cond_scale=3.5", "+vis.interp=true",
             "~vis.condscale_c", "data.trainer.max_epochs=1"]
    want = to_container(compose(CONFIGS, overrides=OVERRIDE_SETS[name] + extra))
    assert to_container(load_config(path, extra)) == want
    assert want["batch_size"] == 4 and want["pl"]["trainer"]["max_epochs"] == 1
    with pytest.raises(ValueError, match="group override"):
        load_config(path, ["data=cifar10"])


@pytest.mark.parametrize("text", VALUES_USED)
def test_override_values_parse_alike_without_pyyaml(text, monkeypatch):
    with_yaml = parse_value(text)
    monkeypatch.setitem(sys.modules, "yaml", None)
    assert parse_value(text) == with_yaml and type(parse_value(text)) is type(with_yaml)


def test_json_config_loads_without_pyyaml(monkeypatch):
    monkeypatch.setitem(sys.modules, "yaml", None)
    cfg = load_config(FIT_JSON, ["data.trainer.max_epochs=2", "log_dir=/tmp/x"])
    assert cfg.pl.trainer.max_epochs == 2 and cfg.sg.params.log_dir == "/tmp/x"
    with pytest.raises(ImportError):
        compose(CONFIGS, overrides=["data=synthetic32"])


def test_committed_fit_config_equals_its_recomposition():
    assert json.loads(FIT_JSON.read_text()) == \
        to_container(compose_unresolved(CONFIGS, overrides=FIT_OVERRIDES))
    cfg = to_container(load_config(FIT_JSON))
    assert cfg == jax_to_container(jax_compose(CONFIGS, overrides=FIT_OVERRIDES))
    # IN64 unet_fast at full width, cluster ids over 1000 classes, batch 128:
    # 1,024 train images (8 batches, 4 taken) and 256 val (2 batches)
    from sgdm_tpu_torch.models.factory import UNET_FAST_IN64

    dyn = {k: v for k, v in cfg["dynamic"]["params"].items() if k != "condition"}
    assert dyn == dict(UNET_FAST_IN64, cond_dim=1000, condition_method="cluster")
    data = cfg["data"]["params"]
    assert (data["batch_size"], data["train"]["params"]["length"],
            data["validation"]["params"]["length"]) == (128, 1024, 256)
    assert cfg["sg"]["params"]["compute_dtype"] == "bfloat16"


def test_targets_read_as_the_port():
    from sgdm_tpu_torch.data.synthetic import SyntheticImages
    from sgdm_tpu_torch.training.trainer import SelfGuidedDiffusionTrainer

    assert get_obj_from_str("sgdm_tpu.data.synthetic.SyntheticImages") is SyntheticImages
    assert get_obj_from_str("sgdm_tpu.training.trainer.SelfGuidedDiffusionTrainer") \
        is SelfGuidedDiffusionTrainer
    from sgdm_tpu_torch.eval.harness import make_val_fid_fn

    assert get_obj_from_str("sgdm_tpu.eval.harness.make_val_fid_fn") is make_val_fid_fn
    from sgdm_tpu_torch.eval.papervis import draw_grid

    assert get_obj_from_str("sgdm_tpu.eval.papervis.draw_grid") is draw_grid
    from sgdm_tpu_torch.utils.trace_summary import summarize

    assert get_obj_from_str("sgdm_tpu.utils.trace_summary.summarize") is summarize
    from sgdm_tpu_torch.data.imagenet_pickle import ImageNetPickle

    assert get_obj_from_str("sgdm_tpu.data.imagenet_pickle.ImageNetPickle") is ImageNetPickle
    from sgdm_tpu_torch.data.voc12 import VOCSegmentation

    assert get_obj_from_str("sgdm_tpu.data.voc12.VOCSegmentation") is VOCSegmentation
    from sgdm_tpu_torch.data.cityscapes import CityscapesDataset

    assert get_obj_from_str("sgdm_tpu.data.cityscapes.CityscapesDataset") is CityscapesDataset
    with pytest.raises(ImportError, match="no 'nope'"):
        get_obj_from_str("sgdm_tpu.models.factory.nope")


@pytest.mark.parametrize("target", [
    "sgdm_tpu.parallel.mesh.create_mesh", "sgdm_tpu.parallel.mesh.local_batch_slice",
    "sgdm_tpu.parallel.mesh.shard_batch", "sgdm_tpu.parallel.fsdp.shard_train_state",
    "sgdm_tpu.parallel.tp.unet_param_pspecs",
])
def test_parallel_targets_resolve(target):
    """The JAX package's parallel modules read as the port's (nothing of
    `parallel` is left in the engine's not-ported table)."""
    from sgdm_tpu_torch.config import engine

    assert not any(k == "parallel" or k.startswith("parallel.") for k in engine._NOT_PORTED)
    obj = get_obj_from_str(target)
    assert obj.__module__ == target.rsplit(".", 1)[0].replace("sgdm_tpu.", "sgdm_tpu_torch.")


@pytest.mark.parametrize("target", [
    "sgdm_tpu.selfsup.stego.StegoInference", "sgdm_tpu.selfsup.stego_train.train_stego",
    "sgdm_tpu.selfsup.cluster_pca.clustering_pca",
    "sgdm_tpu.selfsup.cluster_pca.clustering_ensemble",
    "sgdm_tpu.selfsup.mae_train.train_mae",
])
def test_self_annotation_targets_resolve(target):
    """The engine's entries for STEGO, the PCA clusterer and the SSL
    pre-trainers read as the port's."""
    obj = get_obj_from_str(target)
    assert obj.__module__ == target.rsplit(".", 1)[0].replace("sgdm_tpu.", "sgdm_tpu_torch.")
    assert obj.__name__ == target.rsplit(".", 1)[1]


@pytest.mark.parametrize("target,item", [
    ("sgdm_tpu.diffusion.samplers.v_objective.v_sample", None),
    ("sgdm_tpu.diffusion.vdiff_cli.main", None),
    ("sgdm_tpu.models.zoo_imagen.ImagenUNet", None),
    ("sgdm_tpu.utils.roofline.audit_train_step", None),
    ("sgdm_tpu.diffusion.samplers.pndm.pndm_sample", None),
    ("sgdm_tpu.diffusion.samplers.continuous.LearnedNoiseSchedule", None),
])
def test_sampler_targets(target, item):
    """The samplers of the JAX registry, the v-objective samplers and their
    CLI read as the port's; a module still to port names its ROADMAP item."""
    if item is None:
        obj = get_obj_from_str(target)
        assert obj.__module__ == target.rsplit(".", 1)[0].replace("sgdm_tpu.", "sgdm_tpu_torch.")
    else:
        with pytest.raises(ImportError, match=f"item {item}"):
            get_obj_from_str(target)


def test_committed_in64p_config_equals_its_recomposition():
    from sgdm_tpu_torch.data.imagenet_pickle import ImageNetPickle
    from sgdm_tpu_torch.models.factory import UNET_FAST_IN64

    assert json.loads(IN64P_JSON.read_text()) == \
        to_container(compose_unresolved(CONFIGS, overrides=IN64P_OVERRIDES))
    extra = ["data.h5_file=/srv/cluster5000.h5", "data.root=/srv/imagenet64"]
    cfg = to_container(load_config(IN64P_JSON, extra))
    assert cfg == jax_to_container(jax_compose(CONFIGS, overrides=IN64P_OVERRIDES + extra))
    dyn = {k: v for k, v in cfg["dynamic"]["params"].items() if k != "condition"}
    assert dyn == dict(UNET_FAST_IN64, cond_dim=5000, condition_method="cluster")
    for split in ("train", "validation", "test"):
        ds = cfg["data"]["params"][split]
        assert get_obj_from_str(ds["target"]) is ImageNetPickle
        assert ds["params"]["h5_file"] == "/srv/cluster5000.h5"
        assert ds["params"]["condition_method"] == "cluster"


@pytest.mark.parametrize("run", sorted(SEG_RUNS))
def test_committed_segmentation_configs_equal_their_recomposition(run):
    from sgdm_tpu_torch.data import CocoStuffDataset, VOCSegmentation
    from sgdm_tpu_torch.models.factory import UNETCA_FAST_VOC64

    path = ROOT / "sgdm_tpu_torch" / "configs" / f"{run}.json"
    assert json.loads(path.read_text()) == \
        to_container(compose_unresolved(CONFIGS, overrides=SEG_RUNS[run]))
    cfg = to_container(load_config(path, SEG_LOAD[run]))
    assert cfg == jax_to_container(jax_compose(CONFIGS, overrides=SEG_RUNS[run] + SEG_LOAD[run]))
    dyn = {k: v for k, v in cfg["dynamic"]["params"].items() if k != "condition"}
    want = {k: v for k, v in UNETCA_FAST_VOC64.items() if k not in ("layout_dim", "cond_dim")}
    assert {k: dyn[k] for k in want if k != "condition_method"} == \
        {k: v for k, v in want.items() if k != "condition_method"}
    cls = VOCSegmentation if run == "fit_voc64_lost" else CocoStuffDataset
    for split in ("train", "validation", "test"):
        ds = cfg["data"]["params"][split]
        assert get_obj_from_str(ds["target"]) is cls
        assert ds["params"]["condition_method"] == cfg["sg"]["params"]["condition_method"]
    if run == "fit_voc64_lost":
        assert dyn["cond_dim"] == 100 and cfg["condition"]["clusterlayout"]["how"] == "lost"
        assert cfg["data"]["params"]["train"]["params"]["lost_file"] == "/srv/voc/lost.h5"
    else:
        assert dyn["cond_dim"] is None and cfg["data"]["stego_k"] == 27
        assert cfg["data"]["params"]["train"]["params"]["stego_dir"] == "/srv/stego"


# every data config: the port class it resolves to, or the ROADMAP item that ports it
DATA_CONFIGS = {
    "in64_pickle": "imagenet_pickle.ImageNetPickle", "in32_pickle": "imagenet_pickle.ImageNetPickle",
    "cifar10": "cifar10.CIFAR10", "cifar100": "cifar10.CIFAR100", "ffhq64": "ffhq.FFHQ",
    "synthetic32": "synthetic.SyntheticImages", "synthetic32seg": "synthetic.SyntheticSegImages",
    "voc64": "voc12.VOCSegmentation", "cocostuff64": "cocostuff.CocoStuffDataset",
    "cs64": "cityscapes.CityscapesDataset", "coco64": "coco14.Coco14Dataset", "in32_from224": "imagenet_folder.ImageNetFolder",
    "in64_from224": "imagenet_folder.ImageNetFolder",
}


@pytest.mark.parametrize("name", sorted(DATA_CONFIGS))
def test_data_configs_resolve_or_name_their_item(name):
    import importlib

    assert sorted(p.stem for p in (CONFIGS / "data").glob("*.yaml")) == sorted(DATA_CONFIGS)
    cfg = to_container(compose(CONFIGS, overrides=[f"data={name}"]))
    target = cfg["data"]["params"]["train"]["target"]
    want = DATA_CONFIGS[name]
    if "." in want:
        module, cls = want.rsplit(".", 1)
        port = getattr(importlib.import_module(f"sgdm_tpu_torch.data.{module}"), cls)
        assert get_obj_from_str(target) is port
        assert get_obj_from_str(cfg["data"]["target"]).__module__ == \
            "sgdm_tpu_torch.data.datamodule"
    else:
        with pytest.raises(ImportError, match=f"ROADMAP §1 item {want}"):
            get_obj_from_str(target)


# JAX modules the port holds under another name: the Pallas kernels became
# the port's `ops` modules over `csrc/`, pytorch-fid's replica `inception_ref`,
# the TPU target and compiler options `utils/tpu.py` the port's `device.py`
_PORTED_AS = {"ops.pallas": "ops", "ops.pallas.attention": "ops.attention",
              "ops.pallas.fused_optim": "ops.fused_optim",
              "ops.pallas.groupnorm": "ops.groupnorm", "ops.pallas.resblock": "ops.resblock",
              "eval.torch_inception_ref": "eval.inception_ref", "utils.tpu": "device"}
# JAX modules that work round a cost only the TPU has, so the port needs no
# counterpart: the reason
_NO_COUNTERPART = {
    "utils.fast_rng": "it moves threefry keys onto the TPU's hardware RNG; the port draws "
                      "from torch.Generator and K4 hashes its dropout mask from a seed "
                      "(csrc/conv_core.cuh)",
}


def test_every_jax_module_is_ported_or_not_ported():
    """Each module of `sgdm_tpu` has a port module of the same dotted name
    (or the one `_PORTED_AS` names), or its reason in `_NO_COUNTERPART`;
    `_NOT_PORTED` is empty; no entry names a module the port has, or one the
    JAX package lacks; a target into a ported tooling module reads as the
    port's."""
    from pathlib import Path

    import sgdm_tpu
    import sgdm_tpu_torch
    from sgdm_tpu_torch.config import engine

    def modules(pkg) -> set:
        root = Path(pkg.__file__).parent
        return {".".join(p.relative_to(root).with_suffix("").parts[:-1] if p.name ==
                         "__init__.py" else p.relative_to(root).with_suffix("").parts)
                for p in root.rglob("*.py")} - {""}

    jax_mods, port_mods = modules(sgdm_tpu), modules(sgdm_tpu_torch)
    missing = sorted(m for m in jax_mods - port_mods
                     if _PORTED_AS.get(m) not in port_mods and m not in _NO_COUNTERPART)
    assert not missing, missing
    assert engine._NOT_PORTED == {}
    assert set(_NO_COUNTERPART) <= jax_mods - port_mods
    assert set(_PORTED_AS) <= jax_mods and set(_PORTED_AS.values()) <= port_mods
    assert get_obj_from_str("sgdm_tpu.utils.roofline.audit_train_step").__module__ == \
        "sgdm_tpu_torch.utils.roofline"
    assert get_obj_from_str("sgdm_tpu.models.zoo.VDMUNet").__module__ == \
        "sgdm_tpu_torch.models.zoo"
