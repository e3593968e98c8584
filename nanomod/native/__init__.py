from nanomod.native.build import load_native, native_available  # noqa: F401
