"""Runs the iqn agent: the CLI with --agent=iqn."""

from dqn_zoo_torch.run.agents import run_agent

if __name__ == "__main__":
  run_agent("iqn")
