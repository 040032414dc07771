"""``python -m znicz_tpu_torch serve PKG.zip [options]`` — serve a
deployment package over HTTP (see ``serve --help``)."""

import sys


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] != "serve":
        print("usage: python -m znicz_tpu_torch serve PKG.zip [options]",
              file=sys.stderr)
        return 2
    from znicz_tpu_torch.serving.server import main as serve_main
    return serve_main(argv[1:])


if __name__ == "__main__":
    sys.exit(main())
