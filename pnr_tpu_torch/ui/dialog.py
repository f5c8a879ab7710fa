"""Interactive parameter dialog (terminal-native).

Parity target: the reference's generic Qt parameter dialog
`CommonDialog` (pnr-vaa3d/nf_dialog.h:15-260) and its use by the menu
entry (`Advantra::domenu`, Advantra_plugin.cpp:184-272): labeled
editors built from parallel (item, init) string lists, accept/cancel,
and typed read-back via `get_para` / `get_num`. The host here is a
terminal rather than Vaa3D's Qt event loop, so the "editors" are
stdin prompts showing the defaults (path-like items are prompted the
same way — there is no file-picker in a headless session, matching
the reference behaviour of typing into the line edit). The reference's
hidden help/history buttons (`nf_dialog.h:68-70`, setVisible(false))
have no equivalent surface.
"""

from __future__ import annotations

import sys
from typing import List, Optional, Sequence


class CommonDialog:
    """Prompt-based stand-in for nf_dialog.h's CommonDialog.

    exec_() prompts each item on the terminal (empty input keeps the
    init value; 'cancel' aborts) and returns True when accepted.
    """

    def __init__(
        self,
        items: Sequence[str],
        inits: Optional[Sequence[str]] = None,
        infile=None,
        outfile=None,
    ):
        self.items: List[str] = [str(s) for s in items]
        self.inits: List[str] = (
            [str(s) for s in inits] if inits is not None else [""] * len(self.items)
        )
        if len(self.inits) != len(self.items):
            raise ValueError("items and inits must have equal length")
        self.values: List[str] = list(self.inits)
        self._in = infile or sys.stdin
        self._out = outfile or sys.stdout
        self.accepted = False

    def exec_(self) -> bool:
        self._out.write("*** parameters (empty keeps the default; 'cancel' aborts) ***\n")
        for i, (item, init) in enumerate(zip(self.items, self.inits)):
            self._out.write(f"{item} [{init}]: ")
            self._out.flush()
            line = self._in.readline()
            if not line:  # EOF = accept remaining defaults
                break
            line = line.strip()
            if line.lower() == "cancel":
                self.accepted = False
                return False
            if line:
                self.values[i] = line
        self.accepted = True
        return True

    # Qt-compatible alias (dialog.exec() != QDialog::Accepted)
    exec = exec_

    def _index(self, item: str) -> int:
        try:
            return self.items.index(item)
        except ValueError:
            raise KeyError(f"no dialog item named {item!r}")

    def get_para(self, item: str) -> str:
        """String read-back (nf_dialog.h get_para)."""
        return self.values[self._index(item)]

    def get_num(self, item: str) -> float:
        """Numeric read-back (nf_dialog.h get_num's int/float overloads)."""
        return float(self.values[self._index(item)])


def prompt_parameters(infile=None, outfile=None):
    """The menu-mode parameter flow (Advantra::domenu,
    Advantra_plugin.cpp:184-272): prompt the 11 parameters with the
    reference defaults, validate through PNRConfig (identical range
    checks), return the config or None on cancel."""
    from pnr_tpu_torch.config import PNRConfig

    d = PNRConfig()
    items = [
        "neuritesigmas", "somaradius", "tolerance", "znccth", "kappa",
        "step", "ni", "np", "zdist", "nodepervol", "vol",
    ]
    inits = [
        ",".join(f"{s:g}" for s in d.sigmas),
        str(d.somaradius), f"{d.tolerance:g}", f"{d.znccth:g}",
        f"{d.kappa:g}", str(d.step), str(d.ni), str(d.np),
        f"{d.zdist:g}", str(d.nodepervol), str(d.vol),
    ]
    dlg = CommonDialog(items, inits, infile=infile, outfile=outfile)
    if not dlg.exec_():
        return None
    return PNRConfig.from_cli_params([dlg.get_para(i) for i in items])
