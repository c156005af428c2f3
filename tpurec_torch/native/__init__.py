"""Native (C++) host components of the port: a multithreaded mmap CSV
parser for the preprocessed all-integer tables (the port's own copy of the
JAX package's loader, built with g++ on first use; every entry point falls
back to pandas without a toolchain)."""

from tpurec_torch.native.build import load_library, native_available

__all__ = ["load_library", "native_available"]
