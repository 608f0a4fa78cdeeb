"""Minimal HTML gallery writer: the page structure of the reference's
`dominate` gallery, emitted by hand.

Copied from pix2pixhdaudiosr_tpu/utils/html.py (stdlib only).
"""

from __future__ import annotations

import html as _html
import os
from typing import List, Sequence


class HTML:
    def __init__(self, web_dir: str, title: str, refresh: int = 0):
        self.web_dir = web_dir
        self.img_dir = os.path.join(web_dir, "images")
        self.title = title
        self.refresh = refresh
        self.body: List[str] = []
        os.makedirs(self.img_dir, exist_ok=True)

    def get_image_dir(self) -> str:
        return self.img_dir

    def add_header(self, text: str) -> None:
        self.body.append(f"<h3>{_html.escape(str(text))}</h3>")

    def add_images(self, ims: Sequence[str], txts: Sequence[str],
                   links: Sequence[str], width: int = 512) -> None:
        cells = []
        for im, txt, link in zip(ims, txts, links):
            cells.append(
                '<td style="word-wrap:break-word" halign="center" valign="top">'
                f'<p><a href="images/{link}"><img src="images/{im}" '
                f'style="width:{width}px"></a><br>{_html.escape(str(txt))}</p></td>')
        self.body.append('<table border="1" style="table-layout:fixed">'
                         "<tr>" + "".join(cells) + "</tr></table>")

    def save(self) -> str:
        refresh = (f'<meta http-equiv="refresh" content="{self.refresh}">'
                   if self.refresh else "")
        doc = (f"<!DOCTYPE html><html><head><title>{_html.escape(self.title)}"
               f"</title>{refresh}</head><body>" + "".join(self.body)
               + "</body></html>")
        path = os.path.join(self.web_dir, "index.html")
        with open(path, "w") as f:
            f.write(doc)
        return path
