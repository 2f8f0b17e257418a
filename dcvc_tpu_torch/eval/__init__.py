import os

# the directory that holds the dcvc_tpu_torch package (the checkout)
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def module_env():
    """os.environ with ROOT first on PYTHONPATH: the environment of a
    `python3 -m dcvc_tpu_torch...` process started from any directory."""
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
