"""``python -m gvr_tpu_torch render scene.txt -o out.ppm``"""

from gvr_tpu_torch.cli import main

main()
