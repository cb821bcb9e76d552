"""Runs the double_q agent: the CLI with --agent=double_q."""

from dqn_zoo_torch.run.agents import run_agent

if __name__ == "__main__":
  run_agent("double_q")
