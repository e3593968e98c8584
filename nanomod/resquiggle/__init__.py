from nanomod.resquiggle.pipeline import annotate_folder, annotate_files  # noqa: F401
