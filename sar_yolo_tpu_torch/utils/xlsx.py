"""Dependency-free .xlsx writer, one sheet of inline strings and numbers (port of
`write_xlsx` of `sar_yolo_tpu/utils/xlsx.py`).

The JDE validator mirrors its cumulative results table into `jde_results.xlsx`.
An xlsx file is a zip of five small XML parts; this writes exactly those, enough
for Excel, LibreOffice or pandas to open, without openpyxl.
"""

from __future__ import annotations

import zipfile
from pathlib import Path
from xml.sax.saxutils import escape

_CONTENT_TYPES = (
    '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
    '<Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types">'
    '<Default Extension="rels" ContentType="application/vnd.openxmlformats-package.relationships+xml"/>'
    '<Default Extension="xml" ContentType="application/xml"/>'
    '<Override PartName="/xl/workbook.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>'
    '<Override PartName="/xl/worksheets/sheet1.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.worksheet+xml"/>'
    "</Types>")

_RELS = (
    '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
    '<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">'
    '<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/officeDocument" Target="xl/workbook.xml"/>'
    "</Relationships>")

_WORKBOOK = (
    '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
    '<workbook xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main" '
    'xmlns:r="http://schemas.openxmlformats.org/officeDocument/2006/relationships">'
    '<sheets><sheet name="results" sheetId="1" r:id="rId1"/></sheets></workbook>')

_WORKBOOK_RELS = (
    '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
    '<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">'
    '<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/worksheet" Target="worksheets/sheet1.xml"/>'
    "</Relationships>")


def _cell(value) -> str:
    """One <c> element: numeric when it parses as float, inline string else."""
    s = "" if value is None else str(value)
    try:
        float(s)
        if s.strip() != "" and not s.strip().lower() in ("nan", "inf", "-inf"):
            return f"<c><v>{s.strip()}</v></c>"
    except ValueError:
        pass
    return f'<c t="inlineStr"><is><t xml:space="preserve">{escape(s)}</t></is></c>'


def write_xlsx(path, rows: list[dict], header: list[str] | None = None) -> Path:
    """Write `rows` (list of dicts) as a one-sheet workbook at `path`.

    Column order = `header` or the union of keys in first-seen order.
    """
    path = Path(path)
    if header is None:
        header = []
        for r in rows:
            for k in r:
                if k not in header:
                    header.append(k)
    body = ["<row>" + "".join(_cell(h) for h in header) + "</row>"]
    for r in rows:
        body.append("<row>" + "".join(_cell(r.get(h)) for h in header) + "</row>")
    sheet = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<worksheet xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main">'
        f"<sheetData>{''.join(body)}</sheetData></worksheet>")
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("[Content_Types].xml", _CONTENT_TYPES)
        z.writestr("_rels/.rels", _RELS)
        z.writestr("xl/workbook.xml", _WORKBOOK)
        z.writestr("xl/_rels/workbook.xml.rels", _WORKBOOK_RELS)
        z.writestr("xl/worksheets/sheet1.xml", sheet)
    return path

