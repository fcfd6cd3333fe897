"""CLI: python -m rs_ray_toy_tpu <scene.json> <out.png> (main.rs:55-61)."""

import sys

from .render import deploy_render
from .utils.compile_cache import enable_compile_cache


def main():
    if len(sys.argv) != 3:
        print("usage: python -m rs_ray_toy_tpu <scene.json> <out.png>")
        raise SystemExit(2)
    enable_compile_cache()
    deploy_render(sys.argv[1], sys.argv[2])


if __name__ == "__main__":
    main()
