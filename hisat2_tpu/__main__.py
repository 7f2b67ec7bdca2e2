"""Command dispatcher: python -m hisat2_tpu {align,build,inspect} ...

The reference ships three binaries (hisat2-align, hisat2-build,
hisat2-inspect; hisat2_main.cpp etc.); this multiplexes them behind one
module entry point.  `align` is the default when the first argument is an
option (so `python -m hisat2_tpu -x idx -U r.fq` works).  main(argv) can
also be called in-process, as chip_smoke.py does.
"""

import sys


def main(argv=None):
    from .utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    argv = list(sys.argv[1:] if argv is None else argv)
    cmd = "align"
    if argv and not argv[0].startswith("-"):
        cmd = argv[0]
        argv = argv[1:]
    if cmd == "align":
        from .cli.align import main as m
    elif cmd == "build":
        from .cli.build import main as m
    elif cmd == "inspect":
        from .cli.inspect import main as m
    elif cmd == "extract-splice-sites":
        from .tools.gtf import main_ss as m
    elif cmd == "extract-exons":
        from .tools.gtf import main_exons as m
    elif cmd == "extract-snps-haplotypes":
        from .tools.variants import main as m
    elif cmd == "extract-snps-haplotypes-ucsc":
        from .tools.variants_ucsc import main as m
    elif cmd == "simulate-reads":
        from .tools.simulate import main as m
    elif cmd == "genotype":
        from .genotype.driver import main as m
    else:
        print(f"unknown command {cmd!r}: expected align|build|inspect|"
              "extract-splice-sites|extract-exons|extract-snps-haplotypes|"
              "simulate-reads|genotype", file=sys.stderr)
        return 2
    return m(argv)


if __name__ == "__main__":
    sys.exit(main())
