"""``--msci-create`` in the PyTorch port: the three cases of
``tests/test_msci_create.py`` give ``bpp_tpu``'s strings, and the
port's CLI prints them."""

import pytest

from bpp_tpu.tools.msci_create import msci_create as create_j
from bpp_tpu_torch.tools.msci_create import msci_create

CASES = {
    "hybridization": """
tree ((A,B),C);
define T as A,B
define R as A,B,C
hybridization A T, C R as S H tau=yes,no phi=0.3
""",
    "parallel": """
tree ((A,B),C);
define T as A,B
hybridization A T as S H phi=0.4
""",
    "bidirection": """
tree ((A,B),C);
define T as A,B
define R as A,B,C
bidirection A T, C R as X Y phi=0.2,0.3
""",
}
WANT = {
    "hybridization": ("(((H[&phi=0.300000,tau-parent=yes],A)S,B)T,"
                      "(C)H[&phi=0.700000,tau-parent=no])R;"),
    "bidirection": "(((A,Y[&phi=0.300000])X,B)T,(C,X[&phi=0.200000])Y)R;",
}


@pytest.mark.parametrize("name", list(CASES))
def test_same_string_as_bpp_tpu(name):
    got = msci_create(CASES[name])
    assert got == create_j(CASES[name])
    if name in WANT:
        assert got == WANT[name]
    # the newick reads back as a network
    from bpp_tpu_torch.trees.stree import SpeciesTree
    st = SpeciesTree.from_newick(got, ["A", "B", "C"])
    assert st.n_hybrids == (2 if name == "bidirection" else 1)


def test_cli_prints_the_newick(tmp_path, capsys):
    from bpp_tpu_torch import cli
    path = tmp_path / "defs.txt"
    path.write_text(CASES["bidirection"])
    assert cli.main(["--msci-create", str(path)]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out == ["Newick tree:", WANT["bidirection"]]
