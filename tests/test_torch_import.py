"""The PyTorch port imports without JAX, flax, scikit-learn, ml_dtypes, PyYAML or
the JAX package, and no file of it imports them, and its model classes (2D,
deep supervision, the blocks no plan builds) build and run without them; its
host library is built from its own source."""
import re
import subprocess
import sys
from pathlib import Path

import nndetection_tpu_torch

PKG = Path(nndetection_tpu_torch.__file__).resolve().parent

SLICE_MODULES = [
    "nndetection_tpu_torch",
    "nndetection_tpu_torch.bridge",
    "nndetection_tpu_torch.cli",
    "nndetection_tpu_torch.cli.common",
    "nndetection_tpu_torch.cli.consolidate",
    "nndetection_tpu_torch.cli.convert",
    "nndetection_tpu_torch.cli.evaluate",
    "nndetection_tpu_torch.cli.example",
    "nndetection_tpu_torch.cli.nnunet_interop",
    "nndetection_tpu_torch.cli.predict",
    "nndetection_tpu_torch.cli.prep",
    "nndetection_tpu_torch.cli.sweep",
    "nndetection_tpu_torch.cli.train",
    "nndetection_tpu_torch.cli.utils",
    "nndetection_tpu_torch.core",
    "nndetection_tpu_torch.core.boxes",
    "nndetection_tpu_torch.core.boxes.anchors",
    "nndetection_tpu_torch.core.boxes.coder",
    "nndetection_tpu_torch.core.boxes.matcher",
    "nndetection_tpu_torch.core.boxes.nms",
    "nndetection_tpu_torch.core.boxes.ops",
    "nndetection_tpu_torch.core.boxes.ops_np",
    "nndetection_tpu_torch.core.boxes.sampler",
    "nndetection_tpu_torch.core.boxes.wbc",
    "nndetection_tpu_torch.data",
    "nndetection_tpu_torch.data.aug_presets",
    "nndetection_tpu_torch.data.augment",
    "nndetection_tpu_torch.data.crop",
    "nndetection_tpu_torch.data.dataset",
    "nndetection_tpu_torch.data.dicom",
    "nndetection_tpu_torch.data.example",
    "nndetection_tpu_torch.data.gt_prep",
    "nndetection_tpu_torch.data.instances",
    "nndetection_tpu_torch.data.loader",
    "nndetection_tpu_torch.data.luna_proxy",
    "nndetection_tpu_torch.data.mhd",
    "nndetection_tpu_torch.data.nifti",
    "nndetection_tpu_torch.data.normalize",
    "nndetection_tpu_torch.data.nrrd",
    "nndetection_tpu_torch.data.patching",
    "nndetection_tpu_torch.data.prepare",
    "nndetection_tpu_torch.data.preprocess",
    "nndetection_tpu_torch.data.resample",
    "nndetection_tpu_torch.evaluator",
    "nndetection_tpu_torch.evaluator.case",
    "nndetection_tpu_torch.evaluator.coco",
    "nndetection_tpu_torch.evaluator.det",
    "nndetection_tpu_torch.evaluator.froc",
    "nndetection_tpu_torch.evaluator.hist",
    "nndetection_tpu_torch.evaluator.matching",
    "nndetection_tpu_torch.evaluator.registry",
    "nndetection_tpu_torch.inference",
    "nndetection_tpu_torch.inference.ensembler",
    "nndetection_tpu_torch.inference.loading",
    "nndetection_tpu_torch.inference.predictor",
    "nndetection_tpu_torch.inference.restore",
    "nndetection_tpu_torch.inference.sweeper",
    "nndetection_tpu_torch.inference.tta",
    "nndetection_tpu_torch.losses",
    "nndetection_tpu_torch.models",
    "nndetection_tpu_torch.models.blocks",
    "nndetection_tpu_torch.models.conv",
    "nndetection_tpu_torch.models.decoder",
    "nndetection_tpu_torch.models.encoder",
    "nndetection_tpu_torch.models.heads",
    "nndetection_tpu_torch.models.retina_unet",
    "nndetection_tpu_torch.modules",
    "nndetection_tpu_torch.ops",
    "nndetection_tpu_torch.ops._build",
    "nndetection_tpu_torch.ops.conv_in_stats",
    "nndetection_tpu_torch.ops.instance_norm",
    "nndetection_tpu_torch.ops.iou_matrix",
    "nndetection_tpu_torch.ops.native",
    "nndetection_tpu_torch.ops.nms",
    "nndetection_tpu_torch.ops.suppression",
    "nndetection_tpu_torch.ops.wbc_cluster",
    "nndetection_tpu_torch.parallel",
    "nndetection_tpu_torch.parallel.distributed",
    "nndetection_tpu_torch.parallel.mesh",
    "nndetection_tpu_torch.parallel.spatial",
    "nndetection_tpu_torch.pipeline",
    "nndetection_tpu_torch.planning",
    "nndetection_tpu_torch.planning.anchors_opt",
    "nndetection_tpu_torch.planning.architecture",
    "nndetection_tpu_torch.planning.estimator",
    "nndetection_tpu_torch.planning.planner",
    "nndetection_tpu_torch.projects",
    "nndetection_tpu_torch.projects.Task011_Kits",
    "nndetection_tpu_torch.projects.Task011_Kits.prepare",
    "nndetection_tpu_torch.projects.Task012_LIDC",
    "nndetection_tpu_torch.projects.Task012_LIDC.prepare",
    "nndetection_tpu_torch.projects.Task016_Luna",
    "nndetection_tpu_torch.projects.Task016_Luna.prepare",
    "nndetection_tpu_torch.projects.Task016_Luna.proxy_cv",
    "nndetection_tpu_torch.projects.Task017_CADA",
    "nndetection_tpu_torch.projects.Task017_CADA.prepare",
    "nndetection_tpu_torch.projects.Task019_ADAM",
    "nndetection_tpu_torch.projects.Task019_ADAM.prepare",
    "nndetection_tpu_torch.projects.Task020_RibFrac",
    "nndetection_tpu_torch.projects.Task020_RibFrac.prepare",
    "nndetection_tpu_torch.projects.Task021_ProstateX",
    "nndetection_tpu_torch.projects.Task021_ProstateX.prepare",
    "nndetection_tpu_torch.projects.Task025_LymphNodes",
    "nndetection_tpu_torch.projects.Task025_LymphNodes.prepare",
    "nndetection_tpu_torch.projects.decathlon_converter",
    "nndetection_tpu_torch.train",
    "nndetection_tpu_torch.train.lr",
    "nndetection_tpu_torch.train.trainer",
    "nndetection_tpu_torch.utils",
    "nndetection_tpu_torch.utils.analysis",
    "nndetection_tpu_torch.utils.bench_env",
    "nndetection_tpu_torch.utils.check",
    "nndetection_tpu_torch.utils.config",
    "nndetection_tpu_torch.utils.io",
    "nndetection_tpu_torch.utils.registry",
    "nndetection_tpu_torch.utils.tracking",
]


def test_every_module_is_listed():
    found = set()
    for p in PKG.rglob("*.py"):
        parts = p.relative_to(PKG).with_suffix("").parts
        found.add(".".join(("nndetection_tpu_torch",) + parts).removesuffix(".__init__"))
    assert found == set(SLICE_MODULES)


def test_imports_with_jax_and_flax_blocked():
    code = (
        "import sys\n"
        "for name in ('jax', 'jax.numpy', 'flax', 'flax.linen', 'triton', 'sklearn',\n"
        "             'sklearn.metrics', 'ml_dtypes', 'yaml', 'nndetection_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {SLICE_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k in ('jax', 'sklearn', 'ml_dtypes', 'yaml', 'nndetection_tpu') "
        "or k.startswith(('jax.', 'flax', 'sklearn.', 'nndetection_tpu.')) "
        "for k, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=PKG.parent, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_model_classes_run_with_jax_and_flax_blocked():
    code = (
        "import sys\n"
        "for name in ('jax', 'jax.numpy', 'flax', 'flax.linen', 'triton', 'nndetection_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import torch\n"
        "from nndetection_tpu_torch.models.retina_unet import RetinaUNet, RetinaUNetConfig\n"
        "from nndetection_tpu_torch.models.blocks import SELayer, StackedResidualBlock\n"
        "from nndetection_tpu_torch.models.decoder import PAUFPN\n"
        "cfg = RetinaUNetConfig(dim=2, conv_kernels=((3, 3),) * 3, strides=((2, 2),) * 2,\n"
        "    decoder_levels=(1, 2), patch_size=(32, 32), anchor_width=((4, 8),) * 2,\n"
        "    anchor_height=((4, 8),) * 2, anchor_depth=None, start_channels=8,\n"
        "    fpn_channels=16, head_channels=16, dtype='float32',\n"
        "    segmenter_deep_supervision=True, seg_supervision_levels=2)\n"
        "with torch.no_grad():\n"
        "    out = RetinaUNet(cfg)(torch.zeros(1, 32, 32, 1))\n"
        "    x = torch.zeros(1, 8, 8, 8, 8)\n"
        "    y = SELayer(16, 4)(StackedResidualBlock(8, 16, stride=2)(x))\n"
        "    p = PAUFPN([8, 16], [(1, 1, 1), (2, 2, 2)], [(3, 3, 3)] * 2, (1,), 16)(\n"
        "        [x, torch.zeros(1, 16, 4, 4, 4)])\n"
        "assert out['box_deltas'].shape[-1] == 4 and out['seg_logits_aux1'].shape[1] == 16\n"
        "assert y.shape == (1, 16, 4, 4, 4) and [t.shape[1] for t in p] == [8, 16]\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=PKG.parent, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_no_source_imports_jax():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|flax|jaxlib|optax|ml_dtypes|nndetection_tpu|sklearn)\b",
        re.M)
    offenders = [str(p) for p in PKG.rglob("*.py") if pattern.search(p.read_text())]
    assert offenders == []


def test_native_source_lies_in_the_package():
    """``ops.native`` builds from ``nndetection_tpu_torch/csrc/``, never from
    the JAX package's root ``csrc/``."""
    from nndetection_tpu_torch.ops import _build

    assert _build.HOST_SOURCE == PKG / "csrc" / "nndet_host.cpp"
    assert _build.HOST_SOURCE.exists()
    assert _build.host_library_path().parent == PKG / "_build"
    assert "/csrc/Makefile" not in (PKG / "ops" / "native.py").read_text()
    assert "make" not in (PKG / "ops" / "_build.py").read_text().split()
