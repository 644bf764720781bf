"""`python -m kjarni_tpu_torch` == the port's kjarni CLI (cf. the reference's
kjarni-cli binary, kjarni-cli/src/main.rs); `--device cpu` runs it on the CPU."""

from .cli.main import main

if __name__ == "__main__":
    raise SystemExit(main())
