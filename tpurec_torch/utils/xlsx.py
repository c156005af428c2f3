"""Minimal dependency-free .xlsx writer for matrix artifacts (the port's
own copy of ``tpurec/utils/xlsx.py``).

The reference dumps each CDC affinity matrix as an Excel sheet via
``pd.DataFrame(matrix).to_excel(path, index=False)`` (its
model/cdc.py:398-400).  The port depends on neither openpyxl nor
xlsxwriter, so it emits the file format directly: an .xlsx is a zip of a
few small XML parts (OPC/SpreadsheetML).  Output opens in Excel /
LibreOffice / pandas.read_excel and carries the same content as the
reference's artifact — a header row of column indices followed by the
numeric matrix.
"""

from __future__ import annotations

import math
import zipfile

import numpy as np

_CONTENT_TYPES = (
    '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
    '<Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types">'
    '<Default Extension="rels" '
    'ContentType="application/vnd.openxmlformats-package.relationships+xml"/>'
    '<Default Extension="xml" ContentType="application/xml"/>'
    '<Override PartName="/xl/workbook.xml" ContentType="application/vnd.'
    'openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>'
    '<Override PartName="/xl/worksheets/sheet1.xml" ContentType="application/'
    'vnd.openxmlformats-officedocument.spreadsheetml.worksheet+xml"/>'
    "</Types>"
)

_RELS = (
    '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
    '<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/'
    'relationships"><Relationship Id="rId1" Type="http://schemas.'
    'openxmlformats.org/officeDocument/2006/relationships/officeDocument" '
    'Target="xl/workbook.xml"/></Relationships>'
)

_WORKBOOK = (
    '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
    '<workbook xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/'
    'main" xmlns:r="http://schemas.openxmlformats.org/officeDocument/2006/'
    'relationships"><sheets><sheet name="Sheet1" sheetId="1" r:id="rId1"/>'
    "</sheets></workbook>"
)

_WORKBOOK_RELS = (
    '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
    '<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/'
    'relationships"><Relationship Id="rId1" Type="http://schemas.'
    'openxmlformats.org/officeDocument/2006/relationships/worksheet" '
    'Target="worksheets/sheet1.xml"/></Relationships>'
)


def _col_name(j: int) -> str:
    """0-based column index -> A, B, ..., Z, AA, ..."""
    name = ""
    j += 1
    while j:
        j, rem = divmod(j - 1, 26)
        name = chr(ord("A") + rem) + name
    return name


def write_matrix_xlsx(path: str, matrix: np.ndarray) -> None:
    """Write a 2-D float matrix as Sheet1 of ``path``.

    Layout matches the reference artifact (``to_excel(index=False)``):
    row 1 holds the integer column labels 0..n_col-1, rows 2.. hold the
    matrix values.
    """
    matrix = np.asarray(matrix)
    if matrix.ndim != 2:
        raise ValueError(f"expected 2-D matrix, got shape {matrix.shape}")
    n_row, n_col = matrix.shape

    rows = ['<row r="1">']
    for j in range(n_col):
        rows.append(f'<c r="{_col_name(j)}1"><v>{j}</v></c>')
    rows.append("</row>")
    for i in range(n_row):
        rows.append(f'<row r="{i + 2}">')
        for j in range(n_col):
            v = float(matrix[i, j])
            if math.isfinite(v):
                rows.append(f'<c r="{_col_name(j)}{i + 2}"><v>{v!r}</v></c>')
            else:
                # NaN/Inf are not valid SpreadsheetML numeric cells; an
                # empty cell is what pandas' writer produces for NaN
                rows.append(f'<c r="{_col_name(j)}{i + 2}"/>')
        rows.append("</row>")
    sheet = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<worksheet xmlns="http://schemas.openxmlformats.org/spreadsheetml/'
        '2006/main"><sheetData>' + "".join(rows) + "</sheetData></worksheet>"
    )

    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("[Content_Types].xml", _CONTENT_TYPES)
        zf.writestr("_rels/.rels", _RELS)
        zf.writestr("xl/workbook.xml", _WORKBOOK)
        zf.writestr("xl/_rels/workbook.xml.rels", _WORKBOOK_RELS)
        zf.writestr("xl/worksheets/sheet1.xml", sheet)


def read_matrix_xlsx(path: str) -> np.ndarray:
    """Read back a matrix written by :func:`write_matrix_xlsx` (tests)."""
    import re

    with zipfile.ZipFile(path) as zf:
        sheet = zf.read("xl/worksheets/sheet1.xml").decode()
    rows = []
    for row_xml in re.findall(r"<row [^>]*>(.*?)</row>", sheet):
        cells = re.findall(
            r'<c r="([A-Z]+)\d+"(?:/>|>(?:<v>([^<]*)</v>)?</c>)', row_xml)
        vals = {}
        for col, v in cells:
            j = 0
            for ch in col:
                j = j * 26 + (ord(ch) - ord("A") + 1)
            vals[j - 1] = float(v) if v else float("nan")
        n = max(vals) + 1 if vals else 0
        rows.append([vals.get(j, float("nan")) for j in range(n)])
    return np.asarray(rows[1:])  # drop header row
