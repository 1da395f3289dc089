"""How far float32 runs of the global BAs spread on one problem, in the JAX
package and in the port (a diagnostic run by hand; pytest does not collect
it).

    python3 tests/_ba_spread.py PROBLEM.npz [--iters 10] [--orders 16] [--dense-steps]

PROBLEM.npz holds a BA problem and its camera as ``chip_smoke.py`` keeps
them (``python3 chip_smoke.py --keep-ba DIR`` writes phase 15's to
DIR/phase15_ba_problem.npz: keys prob_<field> and cam_<field>).  Everything
runs on the CPU:

- the distributed BA: JAX's on 1 and on 2 virtual devices (its camera
  system summed in another order), the port's at a world of one on the
  problem as given and with its edges shuffled (its scatters sum in
  another order), in float32 and in float64;
- the dense bundle_adjust: JAX's, and the port's on the problem as given
  and shuffled (float32);
- over --orders shuffled edge orders: the cost of the state each of JAX's
  distributed BA (1 and 2 devices) and the port's (float32 and float64)
  returns, beside the cost it returns (the lowest linearization cost seen);
- the port's float32 distributed BA after 1..iters steps against the same
  on the first 8 of those orders, and against one step fewer.

With --dense-steps it runs only the dense bundle_adjust's LM, step by step
through each package's own functions, on the problem as given and over
--orders shuffled edge orders: for each run, the dampings at which the
solve failed (the Cholesky refused the damped system: a NaN step), those
steps' costs, the returned cost (the last step's) and the returned state's.

With several threads the port's CPU scatters (``index_put_`` with
accumulate) add in a varying order, so two float32 runs of one input may
differ by rounding too.

Each comparison prints ``chip_smoke.ba_agreement``'s measures (the state's
cost, relative; the largest point and residual differences; the scale of
the Sim3 that aligns one run onto the other) as one JSON line.
"""

import argparse
import dataclasses
import json
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=2").strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

jax.config.update("jax_platforms", "cpu")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from orb_slam2_annotate_tpu.geometry.camera import CameraModel as JCam  # noqa: E402
from orb_slam2_annotate_tpu.geometry import lie as jlie  # noqa: E402
from orb_slam2_annotate_tpu.parallel import dist_ba as jdist  # noqa: E402
from orb_slam2_annotate_tpu.solvers import ba_core as jba  # noqa: E402
from orb_slam2_annotate_tpu_torch import convert  # noqa: E402
from orb_slam2_annotate_tpu_torch.geometry import lie as tlie  # noqa: E402
from orb_slam2_annotate_tpu_torch.geometry.camera import CameraModel as TCam  # noqa: E402
from orb_slam2_annotate_tpu_torch.parallel import dist_ba as tdist  # noqa: E402
from orb_slam2_annotate_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from orb_slam2_annotate_tpu_torch.solvers import ba_core as tba  # noqa: E402

EDGE_FIELDS = ("cam_idx", "pt_idx", "uv", "ur", "inv_sigma2", "edge_valid")


def load(path):
    z = dict(np.load(path))
    prob = {k[5:]: v for k, v in z.items() if k.startswith("prob_")}
    cam = {f.name: float(z["cam_" + f.name]) for f in dataclasses.fields(TCam)}
    return prob, cam


def shuffled(prob, seed=0):
    order = np.random.RandomState(seed).permutation(prob["cam_idx"].shape[0])
    return {k: (v[order] if k in EDGE_FIELDS else v) for k, v in prob.items()}


def as_dtype(prob, dtype):
    return {k: (v.astype(dtype) if v.dtype.kind == "f" else v) for k, v in prob.items()}


def port_distributed(cam, prob, iters):
    """The port's distributed BA at a world of one: {R, t, X, cost} as
    numpy, X in the problem's point order."""
    tp = convert.ba_problem_from_numpy(prob, device="cpu")
    if prob["points"].dtype == np.float64:
        tp = tp.replace(**{f.name: getattr(tp, f.name).double() for f in dataclasses.fields(tp)
                           if getattr(tp, f.name).is_floating_point()})
    sp, perm = tdist.shard_ba_problem(tp, 1, return_perm=True)
    R, t, X, cost = tdist.make_distributed_ba(tmesh.Mesh(None, 1, 0), iters=iters)(cam, sp)
    return {"R": R.numpy(), "t": t.numpy(), "X": X[torch.from_numpy(perm)].numpy(),
            "cost": float(cost)}


def jax_distributed(jcam, prob, n_dev, iters):
    jp = jba.BAProblem(**{k: jax.numpy.asarray(v) for k, v in prob.items()})
    sp, perm = jdist.shard_ba_problem(jp, n_dev, return_perm=True)
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("mp",))
    pt, rep = NamedSharding(mesh, P("mp")), NamedSharding(mesh, P())
    sp = sp._replace(**{k: jax.device_put(getattr(sp, k), pt) for k in
                        ("points", "pt_valid", *EDGE_FIELDS)},
                     **{k: jax.device_put(getattr(sp, k), rep) for k in
                        ("R", "t", "cam_fixed", "cam_valid")})
    R, t, X, cost = jdist.make_distributed_ba(mesh, iters=iters)(jcam, sp)
    return {"R": np.asarray(R), "t": np.asarray(t), "X": np.asarray(X)[np.asarray(perm)],
            "cost": float(cost)}


def port_dense(cam, prob, iters):
    prob = convert.ba_problem_from_numpy(prob, device="cpu")
    R, t, X, _, cost = tba.bundle_adjust(cam, prob, iters)
    return {"R": R.numpy(), "t": t.numpy(), "X": X.numpy(), "cost": float(cost)}


def jax_dense(jcam, prob, iters):
    jp = jba.BAProblem(**{k: jax.numpy.asarray(v) for k, v in prob.items()})
    R, t, X, _, cost = jax.jit(jba.bundle_adjust, static_argnums=2)(jcam, jp, iters)
    return {"R": np.asarray(R), "t": np.asarray(t), "X": np.asarray(X), "cost": float(cost)}


def dense_steps(cam, jcam, prob, iters, package):
    """The dense bundle_adjust's LM loop, step by step (as each package's
    ``bundle_adjust`` runs it): [(lambda, solve failed, cost, step's cost,
    kept)] and the returned state's cost."""
    rows = []
    if package == "port":
        p = convert.ba_problem_from_numpy(prob, device="cpu")
        free, ptv = p.cam_valid & ~p.cam_fixed, p.pt_valid[:, None].float()
        R, t, X, lam = p.R, p.t, p.points, torch.tensor(1e-5)
        plans, pairs = tba.dense_setup(p)
        for _ in range(iters):
            Hcc, Hpp, B, gc, gp, cost = tba.build_normal_eqs(cam, p.replace(R=R, t=t, points=X),
                                                             True, plans)
            dc, dp = tba.schur_solve_dense(Hcc, Hpp, B, gc, gp, lam, free, pairs)
            Rn, tn = tlie.se3_retract(R, t, dc)
            Xn = X + dp * ptv
            cn = tba.edge_cost(cam, p.replace(R=Rn, t=tn, points=Xn), plans[3])
            kept = bool(cn < cost)
            rows.append((float(lam), bool(torch.isnan(dc).any()), float(cost), float(cn), kept))
            R, t, X = (Rn, tn, Xn) if kept else (R, t, X)
            lam = lam * (0.3 if kept else 8.0)
        return rows, float(tba.edge_cost(cam, p.replace(R=R, t=t, points=X), plans[3]))
    jnp = jax.numpy
    p = jba.BAProblem(**{k: jnp.asarray(v) for k, v in prob.items()})
    free = p.cam_valid & ~p.cam_fixed
    normal = jax.jit(jba.build_normal_eqs, static_argnums=2)
    solve = jax.jit(jba.schur_solve_dense)
    R, t, X, lam = p.R, p.t, p.points, jnp.asarray(1e-5)
    for _ in range(iters):
        Hcc, Hpp, B, gc, gp, cost = normal(jcam, p._replace(R=R, t=t, points=X), True)
        dc, dp = solve(Hcc, Hpp, B, gc, gp, lam, free)
        Rn, tn = jax.vmap(jlie.se3_retract)(R, t, dc)
        Xn = X + dp * p.pt_valid[:, None]
        cn = normal(jcam, p._replace(R=Rn, t=tn, points=Xn), True)[-1]
        kept = bool(cn < cost)
        rows.append((float(lam), bool(jnp.isnan(dc).any()), float(cost), float(cn), kept))
        R, t, X = (Rn, tn, Xn) if kept else (R, t, X)
        lam = lam * (0.3 if kept else 8.0)
    return rows, float(normal(jcam, p._replace(R=R, t=t, points=X), True)[-1])


def main_dense(cam, jcam, prob, a):
    for package in ("port", "jax"):
        for s in range(-1, a.orders):
            rows, state = dense_steps(cam, jcam, prob if s < 0 else shuffled(prob, 100 + s),
                                      a.iters, package)
            print(json.dumps({"dense": package, "edge_order": "given" if s < 0 else 100 + s,
                              "failed_at_lambda": [r[0] for r in rows if r[1]],
                              "failed_step_costs": sorted({r[3] for r in rows if r[1]}),
                              "last_step_failed": rows[-1][1], "returned_cost": rows[-1][3],
                              "state_cost": state}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("problem")
    ap.add_argument("--iters", type=int, default=chip_smoke.DIST_ITERS)
    ap.add_argument("--orders", type=int, default=16)
    ap.add_argument("--dense-steps", action="store_true")
    a = ap.parse_args()
    prob, camd = load(a.problem)
    cam, jcam = TCam(**camd), JCam(**camd)
    if a.dense_steps:
        return main_dense(cam, jcam, prob, a)
    # the measures are taken on the CPU, float32
    ref = convert.ba_problem_from_numpy(prob, device="cpu")
    shuf = shuffled(prob)
    print(json.dumps({"problem": a.problem, "cameras": int(prob["cam_valid"].sum()),
                      "fixed": int((prob["cam_fixed"] & prob["cam_valid"]).sum()),
                      "points": int(prob["pt_valid"].sum()), "edges": int(prob["edge_valid"].sum()),
                      "stereo_edges": int((prob["edge_valid"] & (prob["ur"] >= 0)).sum()),
                      "cost_before": float(tba.edge_cost(cam, ref))}))

    def compare(name, x, y):
        d = chip_smoke.ba_agreement(cam, ref, x, y)
        print(json.dumps({"pair": name, **d}))

    runs = {
        "jax_dist_1dev": jax_distributed(jcam, prob, 1, a.iters),
        "jax_dist_2dev": jax_distributed(jcam, prob, 2, a.iters),
        "port_dist_f32": port_distributed(cam, prob, a.iters),
        "port_dist_f32_shuffled": port_distributed(cam, shuf, a.iters),
        "port_dist_f64": port_distributed(cam, as_dtype(prob, np.float64), a.iters),
        "port_dist_f64_shuffled": port_distributed(cam, as_dtype(shuf, np.float64), a.iters),
        "jax_dense": jax_dense(jcam, prob, a.iters),
        "port_dense": port_dense(cam, prob, a.iters),
        "port_dense_shuffled": port_dense(cam, shuf, a.iters),
    }
    for x, y in (("jax_dist_1dev", "jax_dist_2dev"), ("port_dist_f32", "port_dist_f32_shuffled"),
                 ("port_dist_f32", "jax_dist_1dev"), ("port_dist_f64", "port_dist_f64_shuffled"),
                 ("port_dist_f32", "port_dist_f64"), ("jax_dist_1dev", "port_dist_f64"),
                 ("jax_dense", "port_dense"), ("port_dense", "port_dense_shuffled"),
                 ("port_dense", "port_dist_f64")):
        compare(f"{x} vs {y}", runs[x], runs[y])

    def state_cost(x):
        return float(tba.edge_cost(cam, ref.replace(R=torch.from_numpy(np.array(x["R"])),
                                                    t=torch.from_numpy(np.array(x["t"])),
                                                    points=torch.from_numpy(np.array(x["X"])))))

    orders = [shuffled(prob, 100 + s) for s in range(a.orders)]
    for name, run in (("jax_dist_1dev", lambda p: jax_distributed(jcam, p, 1, a.iters)),
                      ("jax_dist_2dev", lambda p: jax_distributed(jcam, p, 2, a.iters)),
                      ("port_dist_f32", lambda p: port_distributed(cam, p, a.iters)),
                      ("port_dist_f64", lambda p: port_distributed(
                          cam, as_dtype(p, np.float64), a.iters))):
        rs = [run(p) for p in orders]
        sc, rc = [state_cost(x) for x in rs], [x["cost"] for x in rs]
        print(json.dumps({"run": name, "edge_orders": a.orders, "state_cost": sc,
                          "returned_cost": rc, "state_cost_spread": (max(sc) - min(sc)) / min(sc),
                          "returned_cost_spread": (max(rc) - min(rc)) / min(rc)}))
    keys = ("state_cost", "cost", "rmse_px", "residual_px", "X", "aligned_scale")
    prev = None
    for k in range(1, a.iters + 1):
        base = port_distributed(cam, prob, k)
        ds = [chip_smoke.ba_agreement(cam, ref, port_distributed(cam, p, k), base)
              for p in orders[:8]]
        line = {"port_dist_f32_steps": k, "state_cost": state_cost(base),
                "returned_cost": base["cost"],
                "edge_orders_vs_given_max": {q: max(d[q] for d in ds) for q in keys[:-1]},
                "edge_orders_aligned_scale": [min(d["aligned_scale"] for d in ds),
                                              max(d["aligned_scale"] for d in ds)]}
        if prev is not None:
            d = chip_smoke.ba_agreement(cam, ref, prev, base)
            line["one_step_fewer"] = {q: d[q] for q in keys}
        print(json.dumps(line))
        prev = base


if __name__ == "__main__":
    main()
