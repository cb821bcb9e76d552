"""Runs the c51 agent: the CLI with --agent=c51."""

from dqn_zoo_torch.run.agents import run_agent

if __name__ == "__main__":
  run_agent("c51")
