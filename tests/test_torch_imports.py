"""The PyTorch port imports without jax: every module of the port is
imported in a fresh interpreter and ``jax`` must stay out of
``sys.modules`` (any ``rankpo_tpu`` import would pull it in)."""

import os
import subprocess
import sys

MODULES = [
    "rankpo_tpu_torch",
    "rankpo_tpu_torch.models.config",
    "rankpo_tpu_torch.data.tokenization",
    "rankpo_tpu_torch.data.collators",
    "rankpo_tpu_torch.data.datasets",
    "rankpo_tpu_torch.models.hf_io",
    "rankpo_tpu_torch.ops.attention",
    "rankpo_tpu_torch.ops.flash_attention",
    "rankpo_tpu_torch.ops._build",
    "rankpo_tpu_torch.models.llama",
    "rankpo_tpu_torch.models.base",
    "rankpo_tpu_torch.models.roberta",
    "rankpo_tpu_torch.models.pooling",
    "rankpo_tpu_torch.models.encoder",
    "rankpo_tpu_torch.ops.topk",
    "rankpo_tpu_torch.index.flat",
    "rankpo_tpu_torch.index.encoding",
    "rankpo_tpu_torch.serve.service",
    "rankpo_tpu_torch.serve.batching",
    "rankpo_tpu_torch.serve.multihost",
    "rankpo_tpu_torch.cli.serve",
    "rankpo_tpu_torch.core.precision",
    "rankpo_tpu_torch.losses.contrastive",
    "rankpo_tpu_torch.losses.rankpo",
    "rankpo_tpu_torch.data.loader",
    "rankpo_tpu_torch.train.config",
    "rankpo_tpu_torch.train.state",
    "rankpo_tpu_torch.train.steps",
    "rankpo_tpu_torch.train.checkpoint",
    "rankpo_tpu_torch.train.trainer",
    "rankpo_tpu_torch.utils.flops",
    "rankpo_tpu_torch.cli.arguments",
    "rankpo_tpu_torch.cli.run_contrastive",
    "rankpo_tpu_torch.cli.run_rankpo",
    "rankpo_tpu_torch.core.device",
    "rankpo_tpu_torch.ops.ivf_gather",
    "rankpo_tpu_torch.ops.pq_adc",
    "rankpo_tpu_torch.index.factory",
    "rankpo_tpu_torch.index.ivf",
    "rankpo_tpu_torch.index.refined",
    "rankpo_tpu_torch.index.io",
    "rankpo_tpu_torch.utils.jsonl",
    "rankpo_tpu_torch.utils.model_card",
    "rankpo_tpu_torch.utils.wandb_utils",
    "rankpo_tpu_torch.eval",
    "rankpo_tpu_torch.eval.metrics",
    "rankpo_tpu_torch.eval.evaluator",
    "rankpo_tpu_torch.tools",
    "rankpo_tpu_torch.tools.random_negatives",
    "rankpo_tpu_torch.tools.hard_negatives",
    "rankpo_tpu_torch.tools.predictions",
    "rankpo_tpu_torch.cli.evaluate",
    "rankpo_tpu_torch.cli.get_random_negatives",
    "rankpo_tpu_torch.cli.get_hard_negatives",
    "rankpo_tpu_torch.cli.get_predictions",
    "rankpo_tpu_torch.cli.run_pipeline",
    "rankpo_tpu_torch.tools.autotune",
    "rankpo_tpu_torch.cli.autotune",
    "rankpo_tpu_torch.data.packing",
    "rankpo_tpu_torch.models.packing",
    "rankpo_tpu_torch.train.optim8bit",
    "rankpo_tpu_torch.train.adafactor",
    "rankpo_tpu_torch.train.gradcache",
    "rankpo_tpu_torch.data",
    "rankpo_tpu_torch.models.lora",
    "rankpo_tpu_torch.eval.in_training",
    "rankpo_tpu_torch.core.mesh",
    "rankpo_tpu_torch.parallel",
    "rankpo_tpu_torch.parallel.sharding",
    "rankpo_tpu_torch.utils.distributed",
    "rankpo_tpu_torch.parallel.ring_attention",
    "rankpo_tpu_torch.parallel.fsdp",
]

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_never_loads_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'rankpo_tpu.')) or m == 'rankpo_tpu')\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_no_jax_import_in_sources():
    pkg = os.path.join(ROOT, "rankpo_tpu_torch")
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(pkg):
        paths += [os.path.join(dirpath, n) for n in files if n.endswith(".py")]
    offenders = []
    for path in paths:
        with open(path) as f:
            for i, line in enumerate(f, 1):
                s = line.strip()
                if s.startswith(("import jax", "from jax", "import rankpo_tpu.", "from rankpo_tpu.", "from rankpo_tpu import")):
                    offenders.append(f"{path}:{i}: {s}")
    assert not offenders, offenders
