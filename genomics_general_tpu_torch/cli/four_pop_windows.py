"""fourPopWindows entry point — the extended 12-stat f4 panel
(see cli/abba_windows.py; reference fourPopWindows.py)."""

import sys

from .abba_windows import main as _main


def main(argv=None) -> int:
    return _main(argv, full_panel=True)


if __name__ == "__main__":
    sys.exit(main())
