#!/usr/bin/env bash
# The CLI render over torchrun on 1 and G cards (default 4): the headline
# (random_gaussian_scene(250, seed=0), 1024^2 spp 64, the megakernel) and
# the grid cell (random_gaussian_scene(10_000, seed=0), 512^2 spp 16),
# each rank's --stats line, and how many PPM bytes differ between the
# 1-card and the G-card image.  Run from the repository's root on a
# machine with G cards:
#
#     bash tools/multicard_cli.sh [G]
set -euo pipefail
G=${1:-4}
S=$(mktemp -d)
trap 'rm -rf "$S"' EXIT
python3 -c "from gvr_tpu_torch.scene.generators import random_gaussian_scene as g
open('$S/250.txt', 'w').write(g(250, seed=0))
open('$S/10k.txt', 'w').write(g(10000, seed=0))"
python3 -c "from gvr_tpu_torch.kernels import _build; _build.build(); _build.library()"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for n in 1 "$G"; do
  echo "=== $n ranks"
  python3 -m torch.distributed.run --standalone --nproc-per-node "$n" \
    -m gvr_tpu_torch.cli render "$S/250.txt" -o "$S/h$n.ppm" \
    --width 1024 --height 1024 --spp 64 --stats 2>&1 \
    | grep -E "^\[|Render time"
  python3 -m torch.distributed.run --standalone --nproc-per-node "$n" \
    -m gvr_tpu_torch.cli render "$S/10k.txt" -o "$S/g$n.ppm" \
    --width 512 --height 512 --spp 16 --stats 2>&1 \
    | grep -E "^\[|Render time"
done
echo "headline PPM bytes differing 1 vs $G: $(cmp -l "$S/h1.ppm" "$S/h$G.ppm" | wc -l)"
echo "grid PPM bytes differing 1 vs $G: $(cmp -l "$S/g1.ppm" "$S/g$G.ppm" | wc -l)"
