import sys

from paddle_tpu_torch.distributed.launch import main

sys.exit(main())
