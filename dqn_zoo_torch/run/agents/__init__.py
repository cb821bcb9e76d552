"""Per-agent runners (port of dqn_zoo_tpu/run/agents): each runs the CLI,
`dqn_zoo_torch.run.train`, with `--agent=<name>` put before the caller's
flags, e.g. `python -m dqn_zoo_torch.run.agents.prioritized
--environment_name=pong`."""

from __future__ import annotations

import sys
from typing import Optional, Sequence

from dqn_zoo_torch.run import train


def run_agent(name: str, argv: Optional[Sequence[str]] = None) -> None:
  """The CLI for agent `name` on `argv` (the command line's by default)."""
  argv = sys.argv[1:] if argv is None else list(argv)
  train.cli([f"--agent={name}"] + argv)
