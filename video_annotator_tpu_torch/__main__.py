import sys

from video_annotator_tpu_torch.cli import main

sys.exit(main())
