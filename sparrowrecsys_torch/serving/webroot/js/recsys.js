/* SparrowRecSys PyTorch frontend client.
 *
 * Original implementation (not copied from the reference): plain fetch()
 * against the same five-endpoint JSON API the reference exposes
 * (/getrecommendation, /getsimilarmovie, /getuser, /getmovie,
 * /getrecforyou), including the {"rating": {...}} wrapper on rating lists.
 */

/* Escape catalog strings before any innerHTML interpolation — titles
 * contain '&' and could contain '<' (consistent with movieCard's
 * textContent hardening). */
function esc(s) {
  return String(s).replace(/&/g, "&amp;").replace(/</g, "&lt;")
                  .replace(/>/g, "&gt;").replace(/"/g, "&quot;");
}

async function getJSON(url) {
  const resp = await fetch(url);
  const text = await resp.text();
  if (!text) return null;
  return JSON.parse(text);
}

/* Poster: the reference's URL surface (webroot/posters/<movieId>.jpg).
 * The server renders a deterministic SVG at that path when no binary
 * asset exists (zero-egress build); a real jpg on disk wins. On any
 * load error, fall back to a CSS color block with the title initials. */
function posterBlock(movie) {
  const img = document.createElement("img");
  img.className = "poster";
  img.alt = movie.title || "";
  img.src = `posters/${movie.movieId}.jpg`;
  img.onerror = () => {
    const hue = (movie.movieId * 47) % 360;
    const initials = (movie.title || "?")
      .split(/\s+/).slice(0, 2).map(w => w[0]).join("").toUpperCase();
    const div = document.createElement("div");
    div.className = "poster";
    div.style.background =
      `linear-gradient(160deg, hsl(${hue},45%,35%), hsl(${(hue + 40) % 360},50%,22%))`;
    div.textContent = initials;
    img.replaceWith(div);
  };
  return img;
}

function movieCard(movie) {
  const div = document.createElement("div");
  div.className = "movie-card";
  const year = movie.releaseYear ? ` (${movie.releaseYear})` : "";
  const link = document.createElement("a");
  link.href = `movie.html?movieId=${movie.movieId}`;
  link.appendChild(posterBlock(movie));
  const title = document.createElement("div");
  title.className = "movie-title";
  title.textContent = `${movie.title}${year}`;
  link.appendChild(title);
  div.appendChild(link);
  const meta = document.createElement("div");
  meta.className = "movie-meta";
  meta.innerHTML = `
      <span class="rating">★ ${movie.averageRating.toFixed(2)}</span>
      <span class="genres">${esc(movie.genres.join(", "))}</span>`;
  div.appendChild(meta);
  return div;
}

async function addGenreRow(containerId, genre, size) {
  const movies = await getJSON(
    `/getrecommendation?genre=${encodeURIComponent(genre)}&size=${size}&sortby=rating`);
  const container = document.getElementById(containerId);
  const row = document.createElement("section");
  row.className = "genre-row";
  row.innerHTML = `<h2><a href="collection.html?genre=${encodeURIComponent(genre)}">${esc(genre)}</a></h2>`;
  const strip = document.createElement("div");
  strip.className = "movie-strip";
  (movies || []).forEach(m => strip.appendChild(movieCard(m)));
  row.appendChild(strip);
  container.appendChild(row);
}

async function renderMoviePage(containerId, relatedId, movieId) {
  const movie = await getJSON(`/getmovie?id=${movieId}`);
  const container = document.getElementById(containerId);
  if (!movie) { container.textContent = "Movie not found."; return; }
  const ratings = (movie.topRatings || [])
    .map(r => `<li><span class="avatar" style="background:hsl(${(r.rating.userId * 83) % 360},40%,35%)">${r.rating.userId % 100}</span> user ${r.rating.userId}: ★ ${r.rating.score}</li>`).join("");
  container.innerHTML = `<div class="detail-flex"></div>`;
  const flex = container.firstChild;
  flex.appendChild(posterBlock(movie)).classList.add("poster-lg");
  const info = document.createElement("div");
  info.innerHTML = `
    <h1>${esc(movie.title)} (${movie.releaseYear})</h1>
    <p>${esc(movie.genres.join(" | "))}</p>
    <p>★ ${movie.averageRating.toFixed(2)} from ${movie.ratingNumber} ratings</p>
    <p>IMDb: ${movie.imdbId} · TMDb: ${movie.tmdbId}</p>
    <h3>Top ratings</h3><ul class="rating-list">${ratings}</ul>`;
  flex.appendChild(info);
  const related = await getJSON(`/getsimilarmovie?movieId=${movieId}&size=16&model=emb`);
  const rel = document.getElementById(relatedId);
  rel.innerHTML = "<h2>You may also like</h2>";
  const strip = document.createElement("div");
  strip.className = "movie-strip";
  (related || []).forEach(m => strip.appendChild(movieCard(m)));
  rel.appendChild(strip);
}

async function renderUserPage(detailId, recId, historyId, userId) {
  const user = await getJSON(`/getuser?id=${userId}`);
  const detail = document.getElementById(detailId);
  if (!user) { detail.textContent = "User not found."; return; }
  // avatar placeholder: the reference rotates images/avatar/{0-9}.png by
  // id; a deterministic color disc fills the same slot asset-free.
  detail.innerHTML = `
    <div class="detail-flex">
      <span class="avatar avatar-lg"
            style="background:hsl(${(user.userId * 83) % 360},40%,35%)">${user.userId % 100}</span>
      <div>
        <h1>User ${user.userId}</h1>
        <p>${user.ratingCount} ratings · avg ${user.averageRating.toFixed(2)}
           · high ${user.highestRating} · low ${user.lowestRating}</p>
      </div>
    </div>`;
  const recs = await getJSON(`/getrecforyou?id=${userId}&size=32&model=emb`);
  const recDiv = document.getElementById(recId);
  recDiv.innerHTML = "<h2>Recommended for you</h2>";
  const strip = document.createElement("div");
  strip.className = "movie-strip";
  (recs || []).forEach(m => strip.appendChild(movieCard(m)));
  recDiv.appendChild(strip);

  // History with titles: like the reference (recsys.js:132-155), each
  // rating resolves its movie via /getmovie and renders a full card.
  const hist = document.getElementById(historyId);
  hist.innerHTML = "<h2>Rating history</h2>";
  const strip2 = document.createElement("div");
  strip2.className = "movie-strip";
  hist.appendChild(strip2);
  const wrapped = (user.ratings || []).slice(0, 20);
  const hmovies = await Promise.all(
    wrapped.map(w => getJSON(`/getmovie?id=${w.rating.movieId}`)));
  wrapped.forEach((w, i) => {
    const m = hmovies[i];
    if (!m) return;
    const card = movieCard(m);
    const badge = document.createElement("div");
    badge.className = "movie-meta";
    badge.innerHTML = `<span class="rating">rated ★ ${w.rating.score}</span>`;
    card.appendChild(badge);   // {"rating": {...}} wrapper shape
    strip2.appendChild(card);
  });
}

async function renderCollection(containerId, genre, size) {
  const movies = await getJSON(
    `/getrecommendation?genre=${encodeURIComponent(genre)}&size=${size}&sortby=rating`);
  const container = document.getElementById(containerId);
  container.innerHTML = `<h1>${esc(genre)}</h1>`;
  const grid = document.createElement("div");
  grid.className = "movie-grid";
  (movies || []).forEach(m => grid.appendChild(movieCard(m)));
  container.appendChild(grid);
}

function qsParam(name) {
  return new URLSearchParams(window.location.search).get(name);
}
