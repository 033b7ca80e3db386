"""Nucleotide -> amino acid translation (NCBI genetic code state machine).

Port of src/commons/TranslateNucl.h: IUPAC bases map to a 4-bit code, a
codon is a state in [1, 4096]; ambiguity codes expand into component bases
and translate to B/Z/J/X when the expansion is not unique. Start/stop codon
sets come from the per-table sncbieaa/ncbieaa strings.
"""

import numpy as np

# 4-bit base codes: gap=0, A=1, C=2, M=3, G=4, R=5, S=6, V=7, T=8, W=9,
# Y=10, H=11, K=12, D=13, B=14, N=15
_CHAR_TO_BASE = "-ACMGRSVTWYHKDBN"
_BASE_TO_COMP = "-TGKCYSBAWRDMHVN"
# T=0, C=1, A=2, G=3 (genetic code strings are in TCAG order)
_CODON_IDX = {1: 2, 2: 1, 4: 3, 8: 0}

GENETIC_CODES = {
    1: ("FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
        "---M------**--*----M---------------M----------------------------"),
    2: ("FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIMMTTTTNNKKSS**VVVVAAAADDEEGGGG",
        "----------**--------------------MMMM----------**---M------------"),
    4: ("FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
        "--MM------**-------M------------MMMM---------------M------------"),
    11: ("FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
         "---M------**--*----M------------MMMM---------------M------------"),
}


class TranslateNucl:
    def __init__(self, table: int = 1):
        if table not in GENETIC_CODES:
            raise ValueError(f"translation table {table} not supported "
                             f"(available: {sorted(GENETIC_CODES)})")
        ncbieaa, sncbieaa = GENETIC_CODES[table]
        self.base_to_idx = np.zeros(256, dtype=np.int32)
        for i, ch in enumerate(_CHAR_TO_BASE):
            self.base_to_idx[ord(ch)] = i
            self.base_to_idx[ord(ch.lower())] = i
        self.base_to_idx[ord("U")] = 8
        self.base_to_idx[ord("u")] = 8
        self.base_to_idx[ord("X")] = 15
        self.base_to_idx[ord("x")] = 15
        for i in range(16):
            self.base_to_idx[i] = i

        self.amino_acid = np.full(4097, ord("X"), dtype=np.uint8)
        self.stop_codons = set()
        self.start_codons = set()
        expansions = (1, 2, 4, 8)
        st = 1
        for i in range(16):
            for j in range(16):
                for k in range(16):
                    aa = None
                    orf = None
                    for x in expansions:
                        if not (x & i):
                            continue
                        for y in expansions:
                            if not (y & j):
                                continue
                            for z in expansions:
                                if not (z & k):
                                    continue
                                cd = (16 * _CODON_IDX[x]
                                      + 4 * _CODON_IDX[y] + _CODON_IDX[z])
                                ch = ncbieaa[cd]
                                if aa is None:
                                    aa = ch
                                    if aa == "*":
                                        self.stop_codons.add(cd)
                                elif aa != ch:
                                    if (aa in "BDN") and (ch in "DN"):
                                        aa = "B"
                                    elif (aa in "ZEQ") and (ch in "EQ"):
                                        aa = "Z"
                                    elif (aa in "JIL") and (ch in "IL"):
                                        aa = "J"
                                    else:
                                        aa = "X"
                                ch = sncbieaa[cd]
                                if orf is None:
                                    orf = ch
                                elif orf != ch:
                                    orf = "X"
                                if ch == "M":
                                    self.start_codons.add(cd)
                    if aa is not None:
                        self.amino_acid[st] = ord(aa)
                    st += 1

    def _codon_strings(self, codes) -> list:
        out = []
        for cd in sorted(codes):
            s = ""
            for p in (16, 4, 1):
                q = (cd // p) % 4
                s += "TCAG"[q]
            out.append(s)
        return out

    def get_stop_codons(self) -> list:
        return self._codon_strings(self.stop_codons)

    def get_start_codons(self) -> list:
        return self._codon_strings(self.start_codons)

    def state_of(self, codon: bytes) -> int:
        i = int(self.base_to_idx[codon[0]])
        j = int(self.base_to_idx[codon[1]])
        k = int(self.base_to_idx[codon[2]])
        return 256 * i + 16 * j + k + 1

    def translate(self, nucl: bytes) -> bytes:
        """Translate codons (L//3 residues); lowercase codons stay lower."""
        L = (len(nucl) // 3) * 3
        arr = np.frombuffer(nucl[:L], dtype=np.uint8).reshape(-1, 3)
        idx = self.base_to_idx[arr]
        states = 256 * idx[:, 0] + 16 * idx[:, 1] + idx[:, 2] + 1
        aa = self.amino_acid[states]
        lower = ((arr >= ord("a")) & (arr <= ord("z"))).any(axis=1)
        aa = np.where(lower, aa + 32, aa).astype(np.uint8)
        return aa.tobytes()
