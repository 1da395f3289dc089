"""A rank of a CPU process group for the port's distributed tests
(tests/test_torch_dist_ba.py, tests/test_torch_shard_points.py).

    python tests/_torch_dist_worker.py MODE RANK WORLD PORT DIR

Joins a gloo group of WORLD ranks at localhost:PORT (60 s timeouts), reads
DIR/in.npz, runs MODE and writes DIR/out{RANK}.npz:
  allreduce  init_multi_host from the arguments, an all_reduce of ones;
  env        the same with the group's address in torch's environment
             variables (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK);
  ba         make_distributed_ba on the sharded problem in in.npz (its
             blocks: `shards` if given, else one a rank);
  loop       LoopCloser._dispatch_global_ba on the map in in.npz (anchor,
             iterations), then maybe_fold_gba(force=True);
  fold_agree mesh.all_ranks on flags that hold on every rank, one, none;
             then the loop mode's global BA with its done event standing in
             for a clock that differs by rank: maybe_fold_gba while rank 1's
             BA is still running, then once it is done on both;
  prims, modules, system, free, gba
             the live map's point axis split over the ranks
             (tests/_torch_shard_cases.py): the primitives against their
             plain ops, the map functions against the whole map's, the
             System and the FreeRunner with shard_points=True, and loop
             closing's global BA on the live shards.
"""

import dataclasses
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from orb_slam2_annotate_tpu_torch import convert  # noqa: E402
from orb_slam2_annotate_tpu_torch.geometry.camera import CameraModel  # noqa: E402
from orb_slam2_annotate_tpu_torch.parallel import dist_ba, mesh  # noqa: E402


def main(mode, rank, world, port, out_dir):
    torch.set_num_threads(1)
    rank, world = int(rank), int(world)
    if mode == "env":
        os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=port, WORLD_SIZE=str(world),
                          RANK=str(rank))
        mesh.init_multi_host(device="cpu", timeout_s=60)
    else:
        mesh.init_multi_host(f"localhost:{port}", world, rank, device="cpu", timeout_s=60)
    d = dict(np.load(os.path.join(out_dir, "in.npz"), allow_pickle=True)) \
        if mode not in ("allreduce", "env") else {}
    out = {"world": mesh.world_size(), "rank": torch.distributed.get_rank()}
    if mode in ("allreduce", "env"):
        x = torch.ones(4) * (rank + 1)
        torch.distributed.all_reduce(x)
        out["sum"] = x.numpy()
    elif mode == "ba":
        cam = CameraModel(**{f.name: float(d["cam_" + f.name]) for f in dataclasses.fields(CameraModel)})
        prob = convert.ba_problem_from_numpy(
            {k[5:]: v for k, v in d.items() if k.startswith("prob_")}, device="cpu")
        step = dist_ba.make_distributed_ba(mesh.map_mesh(), iters=int(d["iters"]),
                                           shards=int(d["shards"]) if "shards" in d else None)
        R, t, X, cost = step(cam, prob)
        out.update(R=R.numpy(), t=t.numpy(), X=X.numpy(), cost=cost.numpy())
    elif mode in ("loop", "fold_agree"):
        from orb_slam2_annotate_tpu_torch.pipeline.loop_closing import LoopCloser, LoopCloserConfig

        cam = CameraModel(**{f.name: float(d["cam_" + f.name]) for f in dataclasses.fields(CameraModel)})
        m = convert.map_state_from_numpy({k[2:]: v for k, v in d.items() if k.startswith("m_")},
                                         device="cpu")
        lc = LoopCloser(cam, m.K, LoopCloserConfig(n_words=64, global_ba_iters=int(d["iters"])),
                        device="cpu")
        lc._dispatch_global_ba(m, anchor=int(d["anchor"]))
        g = lc._gba_pending
        if mode == "fold_agree":
            out.update(all_true=mesh.all_ranks(True), rank0_only=mesh.all_ranks(rank == 0),
                       none=mesh.all_ranks(False))

            class Clock:
                """A done event that answers `done`."""

                def __init__(self, done):
                    self.done = done

                def query(self):
                    return self.done

            g["done"] = Clock(rank == 0)
            lc.maybe_fold_gba(m)
            out["folded_while_rank1_runs"] = lc.n_gba_folded
            g["done"] = Clock(True)
            folded = lc.maybe_fold_gba(m)
            out["folded_once_done"] = lc.n_gba_folded
            out.update({"fold_" + k: v for k, v in convert.map_state_to_numpy(folded).items()})
            np.savez(os.path.join(out_dir, f"out{rank}.npz"), **out)
            torch.distributed.destroy_process_group()
            return
        out.update(R=g["R"].numpy(), t=g["t"].numpy(), X=g["X"].numpy(), cost=g["cost"].numpy())
        folded = lc.maybe_fold_gba(m, force=True)
        out.update({"fold_" + k: v for k, v in convert.map_state_to_numpy(folded).items()})
    else:
        import _torch_shard_cases

        out.update(getattr(_torch_shard_cases, "rank_" + mode)(d, out_dir))
    np.savez(os.path.join(out_dir, f"out{rank}.npz"), **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:6])
