"""Runs the qrdqn agent: the CLI with --agent=qrdqn."""

from dqn_zoo_torch.run.agents import run_agent

if __name__ == "__main__":
  run_agent("qrdqn")
