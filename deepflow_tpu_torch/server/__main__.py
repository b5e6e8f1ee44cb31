"""python -m deepflow_tpu_torch.server: see server.py."""

from deepflow_tpu_torch.server.server import main

if __name__ == "__main__":
    main()
