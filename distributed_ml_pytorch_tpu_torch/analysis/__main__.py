import sys

from distributed_ml_pytorch_tpu_torch.analysis.cli import main

if __name__ == "__main__":
    sys.exit(main())
