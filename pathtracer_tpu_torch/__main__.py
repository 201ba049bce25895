"""`python -m pathtracer_tpu_torch <command> [args]`."""

from .cli import main

if __name__ == "__main__":
    main()
