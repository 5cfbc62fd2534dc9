"""The port's overfit bar, through its train and eval CLIs, as
tests/test_overfit_bar.py holds the JAX package's: configs/
overfit_synthetic.yaml (SelfSupModel, DepthResNet-18 + PoseNet, 64x96
Synthetic, batch 8, 768 steps) must reach depth_gt abs_rel < 0.10, and
``cli.eval`` on the best checkpoint must reproduce its value within 5e-3.
Deterministic on the CPU (fixed seeds, fixed data).

Slow tier. The device comes from ``$PN_TEST_DEVICE`` (default ``cpu``); on
the card::

    PN_TEST_DEVICE=cuda python -m pytest tests/test_torch_overfit_bar.py -m slow --noconftest

Without PyYAML the recipe's dict copy (``core/config.OVERFIT_SYNTHETIC``,
held to the yaml by tests/test_torch_port_rules.py) is trained instead.
"""

import copy
import json
import os
import pathlib
import re

import pytest
from tests.torch_cleanup import remove_tmp_path  # noqa: F401 (an autouse fixture)

pytestmark = pytest.mark.slow

ROOT = pathlib.Path(__file__).resolve().parents[1]
BAR = 0.10


def test_port_overfit_reaches_the_bar(tmp_path, capsys):
    from packnet_sfm_tpu_torch.cli import eval as cli_eval
    from packnet_sfm_tpu_torch.cli import train as cli_train
    from packnet_sfm_tpu_torch.core.config import OVERFIT_SYNTHETIC

    device = os.environ.get("PN_TEST_DEVICE", "cpu")
    try:
        import yaml
    except ImportError:
        cfg = copy.deepcopy(OVERFIT_SYNTHETIC)
    else:
        cfg = yaml.safe_load((ROOT / "configs" / "overfit_synthetic.yaml").read_text())
    cfg["checkpoint"]["filepath"] = str(tmp_path / "ckpts")
    trainer = cli_train.train(cfg, device=device)
    with capsys.disabled():
        print(json.dumps({"history": trainer.history}))

    values = {p: float(re.search(r"abs_rel=([0-9.]+)\.ckpt", p.name).group(1))
              for p in (tmp_path / "ckpts").glob("epoch=*_depth_gt_abs_rel=*.ckpt")}
    assert values, "training saved no checkpoints"
    best_ckpt, best = min(values.items(), key=lambda kv: kv[1])
    assert best < BAR, f"best depth_gt abs_rel {best:.3f} >= {BAR}: {sorted(values.values())}"

    capsys.readouterr()
    cli_eval.main(["--checkpoint", str(best_ckpt), "--device", device])
    out = capsys.readouterr().out
    row = [line for line in out.splitlines()
           if line.strip().startswith("|") and " depth_gt " in line]
    assert row, f"eval printed no depth_gt row:\n{out}"
    assert abs(float(row[0].split("|")[2]) - best) < 5e-3, (best, out)
