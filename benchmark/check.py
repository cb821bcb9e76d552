"""The comparison that decides `correct`: the numbers it compares and how.

Each number is 0 where the program and the reference agree exactly; each
has a limit of its own in the cell's workload file (benchmark/workloads/).
  loss_gap      the largest |L_prog − L_ref| / |L_ref| over the three steps;
  grad_gap      the first gradient as Adam took it (its first moment after
                one step over 1 − b1), by the worst leaf: the gap between
                the program's norm and the reference's, over the larger of
                the reference's norm and the median leaf's;
  change_gap    the parameters' change over the three steps, by the worst
                leaf, measured as grad_gap is; leaves whose reference
                gradient is under a thousandth of the median leaf's move by
                round-off alone and are left out;
  act_gap       the actor: for a stream that acts greedily, how far the
                reference's Q-value of the program's action lies below the
                reference's best, over the mean spread of the Q-values; 1
                for a stream that explores and took another action than its
                draw names;
  sample_gap    the sampled leaves against the reference's replay (see
                ReplayModel.sample_gap);
  batch_rows    sampled transitions whose frames, action, return or
                discount differ from the reference's;
  stack_pixels  the largest difference of a pixel of the actor's stacks;
  priority_gap  (prioritized replay) the new priorities, by the worst row,
                over the larger of the row's reference priority and the
                median.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch


def _norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
  return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
          tree.items()}


def _median(values) -> float:
  return float(torch.tensor(sorted(values), dtype=torch.float64).median())


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keep=None) -> Dict[str, float]:
  """Each leaf's gap of norms over the larger of its reference norm and
  the median leaf's."""
  pn, rn = _norms(prog), _norms(ref)
  keys = [k for k in rn if keep is None or k in keep]
  med = _median([rn[k] for k in keys])
  return {k: abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in keys}


def act_gap(q_ref: List[torch.Tensor], actions: List[torch.Tensor],
            draws: List[dict], eps: float) -> float:
  worst = 0.0
  for q, a, d in zip(q_ref, actions, draws):
    a = a.long().to(q.device)
    explore = d["explore_u"] < eps
    scale = float((q.max(-1).values - q.min(-1).values).mean()) or 1e-30
    gap = (q.max(-1).values - q.gather(1, a[:, None])[:, 0]) / scale
    wrong = (a != d["random_action"].long()).to(gap.dtype)
    gap = torch.where(explore, wrong, gap)
    worst = max(worst, float(gap.max()))
  return worst


def batch_rows(prog, ref) -> int:
  n = 0
  for p, r in zip(prog, ref):
    same = (p.s_tm1 == r.s_tm1).flatten(1).all(1) \
        & (p.s_t == r.s_t).flatten(1).all(1) \
        & (p.a_tm1.long() == r.a_tm1.long()) \
        & torch.isclose(p.r_t, r.r_t, rtol=1e-6, atol=1e-7) \
        & torch.isclose(p.discount_t, r.discount_t, rtol=1e-6, atol=1e-7)
    n += int((~same).sum())
  return n


def numbers(prog: dict, ref: dict, draws: List[dict], prioritized: bool,
            detail: Optional[dict] = None) -> Dict[str, float]:
  """The compared numbers of the program's (or a control's) outputs `prog`
  against the reference's `ref` (benchmark/reference/follow.py); `detail`,
  when given, gets each leaf's gaps and the leaves left out."""
  out = {}
  out["loss_gap"] = max(abs(p - r) / max(abs(r), 1e-30)
                        for p, r in zip(prog["losses"], ref["losses"]))
  grads = leaf_gaps(prog["grad1"], ref["grad1"])
  gn = _norms(ref["grad1"])
  med = _median(gn.values())
  moving = {k for k, v in gn.items() if v >= 1e-3 * med}
  p0 = ref["params0"]
  change = lambda p3: {k: p3[k] - p0[k] for k in p3}
  changes = leaf_gaps(change(prog["params3"]), change(ref["params3"]),
                      keep=moving)
  out["grad_gap"] = max(grads.values())
  out["change_gap"] = max(changes.values())
  if detail is not None:
    detail.update(grad_leaves=grads, change_leaves=changes,
                  still=sorted(set(gn) - moving))
  out["act_gap"] = act_gap(ref["q"], prog["actions"], draws, ref["eps"])
  # The program's leaves are judged by the reference; a reference run put
  # in the program's place judged its own.
  out["sample_gap"] = max(prog.get("sample_gap", ref["sample_gap"]))
  out["batch_rows"] = float(batch_rows(prog["batches"], ref["batches"]))
  out["stack_pixels"] = max(
      float((p.to(torch.int16) - r.to(torch.int16)).abs().max())
      for p, r in zip(prog["stacks"], ref["stacks"]))
  if prioritized:
    worst = 0.0
    for p, r in zip(prog["priorities"], ref["priorities"]):
      r = r.double()
      med = float(r.abs().median())
      worst = max(worst, float(((p.double() - r).abs()
                                / torch.clamp(r.abs(), min=max(med, 1e-30))
                                ).max()))
    out["priority_gap"] = worst
  return out


def control_outputs(ctrl: dict) -> dict:
  """A reference run put in the program's place: its own actions, stacks,
  batches and priorities are what it produced."""
  return dict(ctrl, actions=ctrl["own_actions"])


def verdict(nums: Dict[str, float], limits: Dict[str, float]) -> bool:
  missing = set(nums) - set(limits)
  if missing:
    raise KeyError(f"no limit for {sorted(missing)}")
  return all(nums[k] <= limits[k] for k in nums)


def lines(nums: Dict[str, float], limits: Dict[str, float]) -> List[str]:
  return [f"{k} {nums[k]!r} limit {limits[k]!r}" for k in sorted(nums)]
