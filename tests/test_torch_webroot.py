"""The port's static webroot and posters (`sparrowrecsys_torch/serving/server.py`
`_static`, `_poster_svg`) against the JAX server's, on the CPU: the pages
come back byte for byte, a poster is the JAX package's SVG byte for byte,
and a path that leaves the webroot gets 404."""

import os
import re

import pytest

from sparrowrecsys_torch.config import ServingConfig
from sparrowrecsys_torch.serving import server as tserver
from sparrowrecsys_torch.serving.catalog import DataManager, Movie
from sparrowrecsys_tpu.serving import server as jserver

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "data")
WEBROOT = os.path.join(REPO, "sparrowrecsys_torch", "serving", "webroot")
PAGE_FUNCS = ("addGenreRow", "renderMoviePage", "renderUserPage",
              "renderCollection", "qsParam", "posterBlock", "movieCard")


@pytest.fixture(scope="module")
def server():
    dm = DataManager().load_data(f"{DATA}/movies.csv", None, None, None, None)
    return tserver.RecSysServer(dm, ServingConfig(port=0, model_poll_s=0), device="cpu")


def _get(server, path):
    return server.handle(path, lambda k, d="": d)


@pytest.mark.parametrize("path,name,ctype", [
    ("/", "index.html", "text/html"), ("/index.html", "index.html", "text/html"),
    ("/movie.html", "movie.html", "text/html"), ("/user.html", "user.html", "text/html"),
    ("/collection.html", "collection.html", "text/html"),
    ("/js/recsys.js", "js/recsys.js", "application/javascript"),
    ("/css/style.css", "css/style.css", "text/css"),
    ("/css%2Fstyle.css", "css/style.css", "text/css"),
])
def test_pages_come_back_byte_for_byte(server, path, name, ctype):
    status, got_type, body = _get(server, path)
    with open(os.path.join(WEBROOT, name), "rb") as f:
        assert (status, got_type, body) == (200, ctype, f.read())


@pytest.mark.parametrize("path", ["/../server.py", "/webroot_x", "/../webroot_x/index.html",
                                  "/%2e%2e/server.py", "/js/../../server.py", "/nope.html",
                                  "/posters/999999.jpg", "/posters/x.jpg", "/posters/../server.py"])
def test_paths_outside_the_webroot_get_404(server, path):
    assert _get(server, path)[0] == 404


def test_a_sibling_directory_with_the_webroot_as_prefix_is_refused(tmp_path):
    root = tmp_path / "webroot"
    root.mkdir()
    (root / "a.html").write_bytes(b"in")
    (tmp_path / "webroot_x").mkdir()
    (tmp_path / "webroot_x" / "b.html").write_bytes(b"out")
    srv = tserver.RecSysServer(DataManager(), ServingConfig(port=0, model_poll_s=0),
                               device="cpu", webroot=str(root))
    assert _get(srv, "/a.html") == (200, "text/html", b"in")
    assert _get(srv, "/../webroot_x/b.html")[0] == 404


def test_posters_are_the_jax_svg(server):
    for mid in (1, 2, 50, 858):
        status, ctype, body = _get(server, f"/posters/{mid}.jpg")
        assert (status, ctype) == (200, "image/svg+xml")
        assert body == jserver._poster_svg(server.dm.get_movie_by_id(mid))
        assert body.startswith(b'<svg xmlns="http://www.w3.org/2000/svg"')


@pytest.mark.parametrize("movie", [
    Movie(7, "Tom & Jerry's <Big> Adventure: A Very Long Title", 1999, genres=["Comedy"]),
    Movie(8, "", 0, genres=[]),
    Movie(9, "Amélie", 2001, genres=["Romance", "Comedy"]),
])
def test_poster_svg_equals_jax_on_awkward_titles(movie):
    assert tserver._poster_svg(movie) == jserver._poster_svg(movie)


def test_a_poster_file_on_disk_wins(tmp_path):
    root = tmp_path / "webroot"
    (root / "posters").mkdir(parents=True)
    (root / "posters" / "1.jpg").write_bytes(b"\xff\xd8jpeg")
    dm = DataManager().load_data(f"{DATA}/movies.csv", None, None, None, None)
    srv = tserver.RecSysServer(dm, ServingConfig(port=0, model_poll_s=0), device="cpu",
                               webroot=str(root))
    assert _get(srv, "/posters/1.jpg") == (200, "image/jpeg", b"\xff\xd8jpeg")
    assert _get(srv, "/posters/2.jpg")[1] == "image/svg+xml"


def test_the_pages_call_functions_recsys_js_defines():
    with open(os.path.join(WEBROOT, "js", "recsys.js")) as f:
        src = f.read()
    for o, c in ("{}", "()", "[]"):
        assert src.count(o) == src.count(c), o
    for fn in PAGE_FUNCS:
        assert re.search(rf"function {fn}\(", src), fn
    for page in ("index", "movie", "user", "collection"):
        with open(os.path.join(WEBROOT, f"{page}.html")) as f:
            html = f.read()
        assert 'src="js/recsys.js"' in html
        for m in re.finditer(r"(\w+)\(", html):
            if m.group(1) in PAGE_FUNCS:
                assert re.search(rf"function {m.group(1)}\(", src), (page, m.group(1))
