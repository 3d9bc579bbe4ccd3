"""The periodic table's symbols and atomic numbers (a copy of the JAX
package's ``data/elements.py``).

The raw readers (QM9's sdf, extxyz frames, MPtrj's JSON) need symbol -> Z
for every element (MPtrj spans H to Pu): one table, no dependencies.
"""

_SYMBOL_LIST = [
    "H", "He", "Li", "Be", "B", "C", "N", "O", "F", "Ne",
    "Na", "Mg", "Al", "Si", "P", "S", "Cl", "Ar", "K", "Ca",
    "Sc", "Ti", "V", "Cr", "Mn", "Fe", "Co", "Ni", "Cu", "Zn",
    "Ga", "Ge", "As", "Se", "Br", "Kr", "Rb", "Sr", "Y", "Zr",
    "Nb", "Mo", "Tc", "Ru", "Rh", "Pd", "Ag", "Cd", "In", "Sn",
    "Sb", "Te", "I", "Xe", "Cs", "Ba", "La", "Ce", "Pr", "Nd",
    "Pm", "Sm", "Eu", "Gd", "Tb", "Dy", "Ho", "Er", "Tm", "Yb",
    "Lu", "Hf", "Ta", "W", "Re", "Os", "Ir", "Pt", "Au", "Hg",
    "Tl", "Pb", "Bi", "Po", "At", "Rn", "Fr", "Ra", "Ac", "Th",
    "Pa", "U", "Np", "Pu", "Am", "Cm", "Bk", "Cf", "Es", "Fm",
    "Md", "No", "Lr", "Rf", "Db", "Sg", "Bh", "Hs", "Mt", "Ds",
    "Rg", "Cn", "Nh", "Fl", "Mc", "Lv", "Ts", "Og",
]

SYMBOL_TO_Z = {s: i + 1 for i, s in enumerate(_SYMBOL_LIST)}
Z_TO_SYMBOL = {i + 1: s for i, s in enumerate(_SYMBOL_LIST)}


def atomic_number(symbol: str) -> int:
    """Symbol -> Z; forgiving of case (``'FE'``, ``'fe'``)."""
    s = symbol.strip()
    if s in SYMBOL_TO_Z:
        return SYMBOL_TO_Z[s]
    s = s.capitalize()
    if s in SYMBOL_TO_Z:
        return SYMBOL_TO_Z[s]
    raise KeyError(f"unknown element symbol {symbol!r}")


def symbol(z: int) -> str:
    return Z_TO_SYMBOL[int(z)]
