"""Runs the prioritized agent: the CLI with --agent=prioritized."""

from dqn_zoo_torch.run.agents import run_agent

if __name__ == "__main__":
  run_agent("prioritized")
