import sys

from seaweedfs_tpu_torch.command import main

sys.exit(main())
