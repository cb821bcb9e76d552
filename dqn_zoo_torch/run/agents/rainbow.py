"""Runs the rainbow agent: the CLI with --agent=rainbow."""

from dqn_zoo_torch.run.agents import run_agent

if __name__ == "__main__":
  run_agent("rainbow")
