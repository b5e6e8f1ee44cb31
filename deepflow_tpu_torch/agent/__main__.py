"""python -m deepflow_tpu_torch.agent: see agent.py."""

from deepflow_tpu_torch.agent.agent import main

if __name__ == "__main__":
    main()
