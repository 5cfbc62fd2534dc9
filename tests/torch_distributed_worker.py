"""One rank of tests/test_torch_distributed.py, launched by it with
``torch.distributed.run --standalone --nproc_per_node 2``; imports only the
port, torch and numpy.

    python -m torch.distributed.run --standalone --nproc_per_node 2 \\
        tests/torch_distributed_worker.py <data dir>

The test writes the starting weights, the batches and the configs into
<data dir>; each rank joins the gloo group on the CPU, runs every case on
its rows and writes what it got to <data dir>/rank<r>.pt:
- 'resnet': one Adam step of DepthResNet-18 + PoseNet on its 4 rows of the
  global batch of 8 (loss, state dict), and the same with the cross-rank
  BatchNorm switched off ('resnet_local', the control);
- 'accum': the same step with grad_accum = 2;
- 'nrs': one Adam step of the NRS model on its one row of the global batch
  of 2 (the omnicam loss with its clip_loss 0.5);
- 'validate': Trainer.validate over the 13-sample split;
- 'faults': the run name and checkpoint path with a stub W&B logger on
  rank 0 (ROADMAP.md §3 (d)), and ModelCheckpoint's decision and path for a
  monitored value that differs between the ranks (§3 (e));
- 'infer_lines': the files that cli.infer took on this rank;
- 'group': process_index, process_count and the host collectives.
"""

import contextlib
import io
import json
import os
import sys

import numpy as np
import torch

from packnet_sfm_tpu_torch.core.config import ConfigNode, config_from_dict, parse_train_config
from packnet_sfm_tpu_torch.engine.factory import make_optimizer, setup_model
from packnet_sfm_tpu_torch.engine.train import make_train_step, zero_metrics
from packnet_sfm_tpu_torch.parallel import mesh

STEPS_PER_EPOCH = 1000


def rows(batch, lo, hi):
    return {k: [v[lo:hi] for v in val] if isinstance(val, list) else val[lo:hi]
            for k, val in batch.items()}


def load_batch(path):
    data = np.load(path)
    out = {k: data[k] for k in data.files if not k.startswith("ctx")}
    out["rgb_context"] = [data[k] for k in sorted(data.files) if k.startswith("ctx")]
    return out


def one_step(cfg_dict, state0, batch, progress=0.0, grad_accum=1):
    cfg = config_from_dict(cfg_dict)
    model = setup_model(cfg.model, device="cpu")
    model.load_state_dict(state0, strict=True)
    optimizer, scheduler = make_optimizer(model, cfg.model.optimizer, cfg.model.scheduler,
                                          STEPS_PER_EPOCH)
    step = make_train_step(model, optimizer, scheduler, grad_accum=grad_accum)
    acc = step(zero_metrics("cpu"), batch, progress)
    return dict(loss=float(acc["loss"][0]), metrics={k: float(v[0]) for k, v in acc.items()
                                                   if float(v[1]) > 0},
                state={k: v.clone() for k, v in model.state_dict().items()},
                optimizer_keys=sorted(optimizer.state_dict()["state"]))


class StubLogger:
    """W&B stand-in: a run name, and a record of where it was built."""

    built_on = []

    def __init__(self, **kwargs):
        StubLogger.built_on.append(mesh.process_index())
        self.run_name, self.run_url, self.dry_run = "stub-run", "https://stub/run", False

    def log_config(self, config):
        pass

    def log_metrics(self, metrics, step):
        pass

    def log_depth_images(self, *args, **kwargs):
        pass


def faults(data_dir, rank):
    from packnet_sfm_tpu_torch.engine import checkpoint
    from packnet_sfm_tpu_torch.engine.trainer import Trainer
    from packnet_sfm_tpu_torch.utils import wandb_logger

    wandb_logger.WandbLogger = StubLogger
    with open(os.path.join(data_dir, "trainer_config.json")) as f:
        cfg = parse_train_config(ConfigNode.from_dict(json.load(f)))
    cfg.wandb.dry_run = False
    cfg.checkpoint.filepath = os.path.join(data_dir, "ckpt")
    trainer = Trainer(cfg, device="cpu")
    ckpt = checkpoint.ModelCheckpoint(trainer.config.checkpoint.filepath, monitor="loss",
                                      save_top_k=1)
    # a monitored value that differs between the ranks: rank 0's decides
    first = ckpt.check_and_save(trainer.model, cfg.to_dict(), 0, {"loss": 0.5 + rank})
    second = ckpt.check_and_save(trainer.model, cfg.to_dict(), 1, {"loss": 0.25 + 10 * rank})
    third = ckpt.check_and_save(trainer.model, cfg.to_dict(), 2, {"loss": 0.75 - rank})
    mesh.barrier()
    return dict(logger_built_on=StubLogger.built_on, filepath=cfg.checkpoint.filepath,
                run_name=cfg.wandb.name, paths=[first, second, third],
                on_disk=sorted(os.listdir(cfg.checkpoint.filepath)))


def main():
    data_dir = sys.argv[1]
    torch.set_num_threads(1)
    mesh.init_distributed(device="cpu")
    rank, world = mesh.process_index(), mesh.process_count()
    state0 = torch.load(os.path.join(data_dir, "resnet_state0.pt"))
    with open(os.path.join(data_dir, "configs.json")) as f:
        configs = json.load(f)
    out = {"group": dict(rank=rank, world=world,
                         host_sum=mesh.all_reduce_host_sum(
                             {"x": np.array([rank + 1.0]), "y": [np.arange(3) * rank]}),
                         flag_one=mesh.any_process_flag(rank == 1),
                         flag_none=mesh.any_process_flag(False),
                         broadcast=mesh.broadcast_object(f"from rank {rank}"))}

    batch8 = load_batch(os.path.join(data_dir, "batch8.npz"))
    local = rows(batch8, 4 * rank, 4 * rank + 4)
    out["resnet"] = one_step(configs["resnet"], state0, local)
    out["accum"] = one_step(configs["resnet"], state0, local, grad_accum=2)
    from packnet_sfm_tpu_torch.nn import resnet

    global_batch_norm = resnet.batch_group
    resnet.batch_group = lambda: None           # the control: each rank's own statistics
    out["resnet_local"] = one_step(configs["resnet"], state0, local)
    resnet.batch_group = global_batch_norm

    nrs_state0 = torch.load(os.path.join(data_dir, "nrs_state0.pt"))
    batch2 = load_batch(os.path.join(data_dir, "nrs_batch2.npz"))
    out["nrs"] = one_step(configs["nrs"], nrs_state0, rows(batch2, rank, rank + 1),
                          progress=configs["nrs_progress"])

    from packnet_sfm_tpu_torch.engine.trainer import Trainer

    with open(os.path.join(data_dir, "trainer_config.json")) as f:
        cfg = parse_train_config(ConfigNode.from_dict(json.load(f)))
    trainer = Trainer(cfg, device="cpu")
    trainer.model.load_state_dict(torch.load(os.path.join(data_dir, "trainer_state0.pt")))
    out["validate"] = [{m: np.asarray(v) for m, v in res.items()}
                       for res in trainer.validate(0)]
    out["val_batches"] = len(trainer.val_loaders[0])

    out["faults"] = faults(data_dir, rank)

    from packnet_sfm_tpu_torch.cli.infer import infer_and_save

    printed = io.StringIO()                     # infer's line per file
    with contextlib.redirect_stdout(printed):
        infer_and_save(os.path.join(data_dir, "infer_ckpt"), os.path.join(data_dir, "frames"),
                       os.path.join(data_dir, "infer_out"), save="npz", device="cpu")
    out["infer_lines"] = printed.getvalue().splitlines()
    mesh.barrier()
    torch.save(out, os.path.join(data_dir, f"rank{rank}.pt"))
    mesh.shutdown()


if __name__ == "__main__":
    main()
