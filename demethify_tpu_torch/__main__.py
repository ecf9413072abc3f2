import sys

from demethify_tpu_torch.cli import main

sys.exit(main())
